"""Compute ops: the RBF warp, the SA attention and ProgGAN's fused tail (each
plain and as a CUDA kernel), upfirdn2d, fused bias + leaky ReLU."""
