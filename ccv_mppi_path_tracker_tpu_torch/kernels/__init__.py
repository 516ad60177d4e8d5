"""Hand-written CUDA kernels, their wrappers, plain versions and build."""
