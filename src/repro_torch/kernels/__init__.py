"""Hand-written CUDA kernels (K1-K8), their plain versions and dispatch."""
