"""Training of the CNN-LSTM: the fold trainer (streaming and device-resident) and checkpoints."""
