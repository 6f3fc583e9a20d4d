"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version in ``ref.py``; ``ops.py`` dispatches between them."""
