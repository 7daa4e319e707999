"""Evaluation: stratified splits, classification metrics (numpy) and the CNN-LSTM CV engines."""
