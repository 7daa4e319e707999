"""PyTorch ops of the port; kernels live under ``cuda/``."""
