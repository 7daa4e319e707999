"""Evaluation: stratified splits and classification metrics (numpy)."""
