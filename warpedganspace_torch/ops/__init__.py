"""Compute ops: the RBF warp (plain and the CUDA kernel), upfirdn2d, fused bias + leaky ReLU."""
