"""Hand-written CUDA kernels (built with nvcc, bound with ctypes) and their plain PyTorch versions."""
