"""warpedganspace_torch — WarpedGANSpace in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

The port of :mod:`warpedganspace_tpu` (JAX on a TPU), which stays the
reference it is tested against. Module names mirror the JAX package:

- :mod:`warpedganspace_torch.ops`      — RBF warp, SA attention (forward and
  backward) and ProgGAN's fused tail (each plain and as a CUDA kernel),
  upfirdn2d, fused bias + leaky ReLU;
- :mod:`warpedganspace_torch.models`   — support sets, the StyleGAN2, BigGAN and
  ProgGAN generators, the uniform generator contract, ``gan_load`` and the
  reconstructor (ResNet-18 and LeNet);
- :mod:`warpedganspace_torch.convert`  — reference ``g_ema`` / ``G_ema`` / ProgGAN /
  reconstructor state dicts and JAX parameter pytrees into the port's modules;
- :mod:`warpedganspace_torch.config`, :mod:`warpedganspace_torch.utils` — the
  weights registry, ``.pt`` IO, experiment bookkeeping and the progress UI (the
  port's own copies: it imports nothing of the JAX package);
- :mod:`warpedganspace_torch.core`     — latent-code and training-directive
  sampling, the statistics tracker;
- :mod:`warpedganspace_torch.train`    — the contrastive training step and the trainer;
- :mod:`warpedganspace_torch.traverse` — path integration, rendering, JPEG/GIF output;
- :mod:`warpedganspace_torch.cli`      — ``sample_gan``, ``train`` and
  ``traverse_latent_space``.

CUDA sources live in ``csrc/`` and are built with ``nvcc`` at first use into
``build/warpedganspace_torch/``.
"""
