"""Compute ops: the RBF warp and the SA attention (each plain and as a CUDA
kernel), upfirdn2d, fused bias + leaky ReLU."""
