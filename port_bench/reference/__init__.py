"""Plain PyTorch references the program is held to."""
