"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``) beside
their plain PyTorch versions, and the plain tensor ops around them."""
