"""Hand-written CUDA kernels (csrc/), their wrappers and plain versions."""
