"""Image ops, the correlation lookup and the CUDA kernels' wrappers."""
