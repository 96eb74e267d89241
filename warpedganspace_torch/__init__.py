"""warpedganspace_torch — WarpedGANSpace in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

The port of :mod:`warpedganspace_tpu` (JAX on a TPU), which stays the
reference it is tested against. Module names mirror the JAX package:

- :mod:`warpedganspace_torch.ops`      — RBF warp, SA attention and ProgGAN's
  fused tail (each plain and as a CUDA kernel), upfirdn2d, fused bias + leaky ReLU;
- :mod:`warpedganspace_torch.models`   — support sets, the StyleGAN2, BigGAN and
  ProgGAN generators, the uniform generator contract and ``gan_load``;
- :mod:`warpedganspace_torch.convert`  — reference ``g_ema`` / ``G_ema`` / ProgGAN
  state dicts and JAX parameter pytrees into the port's modules;
- :mod:`warpedganspace_torch.config`, :mod:`warpedganspace_torch.utils` — the
  weights registry, ``.pt`` IO and the progress UI (the port's own copies: it
  imports nothing of the JAX package);
- :mod:`warpedganspace_torch.core`     — latent-code sampling;
- :mod:`warpedganspace_torch.traverse` — path integration, rendering, JPEG/GIF output;
- :mod:`warpedganspace_torch.cli`      — ``sample_gan`` and ``traverse_latent_space``.

CUDA sources live in ``csrc/`` and are built with ``nvcc`` at first use into
``build/warpedganspace_torch/``.
"""
