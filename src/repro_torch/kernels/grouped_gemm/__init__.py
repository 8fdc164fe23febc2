"""The grouped GEMM: one matrix product per group of rows, for the
dropless MoE dispatch; CUDA kernels, each with a plain PyTorch version."""
