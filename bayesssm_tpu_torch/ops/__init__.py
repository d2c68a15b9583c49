"""Kernels and their plain PyTorch versions: the counter RNG, threefry
keys, weights, selection, resampling, the fused weight step, the Gillespie
day-step and the whole-sweep filter (``csrc/`` holds the CUDA sources)."""
