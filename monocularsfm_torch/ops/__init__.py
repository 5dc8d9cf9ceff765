"""Device compute ops: descriptor matching, SIFT, the CUDA kernels' wrappers."""
