"""Kernels and their plain PyTorch versions: the counter RNG, weights,
selection and the whole-sweep filter (``csrc/`` holds the CUDA sources)."""
