"""Hand-written CUDA kernels for the hot compute paths, with plain versions."""
