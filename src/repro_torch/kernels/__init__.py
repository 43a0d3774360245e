"""Hand-written CUDA kernels of the port, one sub-package each."""
