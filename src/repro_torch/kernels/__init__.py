"""Hand-written CUDA kernels for Hopper (csrc/) and their PyTorch wrappers.
CUDA sources are compiled on first use, never at import."""
