"""Detection, sampling and matching ops, and the two CUDA kernel wrappers."""
