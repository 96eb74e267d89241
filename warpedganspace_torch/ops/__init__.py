"""Compute ops: the RBF warp, the SA attention, ProgGAN's fused tail and
StyleGAN2's fused tail (each plain and as a CUDA kernel: ``rbf``/``rbf_cuda``,
``attn``/``attn_cuda``, ``proggan_tail``/``proggan_tail_cuda``,
``sg2_tail``/``sg2_tail_cuda``; ``sg2_tail`` also holds StyleGAN2's modulated
convolution), upfirdn2d, fused bias + leaky ReLU."""
