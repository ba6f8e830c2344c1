"""Hand-written CUDA kernels for Hopper, built with nvcc at first use and
bound with ctypes (``build``), and their wrappers."""
