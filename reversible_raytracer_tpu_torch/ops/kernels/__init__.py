"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and plain
versions (`fused`), and the nvcc build (`_build`)."""
