"""Hand-written CUDA kernels (K1, K2), their plain versions and dispatch."""
