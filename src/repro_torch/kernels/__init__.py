"""Hand-written CUDA kernels (K1-K7), their plain versions and dispatch."""
