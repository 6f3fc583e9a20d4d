"""PyTorch/CUDA port of the KevlarFlow serving system.

Mirrors the JAX package's layout module for module. Decode attention runs
through a hand-written CUDA kernel (``kernels/csrc/paged_attention.cu``) on
the card; a tensor on the CPU takes the kernel's plain PyTorch version.
"""
