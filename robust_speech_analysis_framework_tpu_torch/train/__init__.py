"""Training of the CNN-LSTM: the streaming fold trainer and checkpoints."""
