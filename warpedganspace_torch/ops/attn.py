"""SA-GAN spatial attention (BigGAN's non-local block), plain PyTorch.

Counterpart of ``_jnp_attention`` in :mod:`warpedganspace_tpu.ops.attn_pallas`
(reference ``models/BigGAN/layers.py:141-166``): per sample,
``softmax(theta @ phi^T) @ g`` with no scale on the logits. The layout is the
JAX package's: theta (B, N, dk), phi (B, M, dk), g (B, M, dv) -> (B, N, dv).

This is the plain version of the CUDA kernel in
:mod:`warpedganspace_torch.ops.attn_cuda`; it materializes the (B, N, M)
attention matrix, which the kernel never does.
"""
from __future__ import annotations

import torch


def sa_attention_plain(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(theta phi^T) g, softmax in float32 whatever the storage type.

    Logits are accumulated in float32, the softmax runs in float32, the
    weights are cast to ``g.dtype`` and the value product is accumulated in
    float32 again; the result is returned in ``theta.dtype``.
    """
    s = torch.bmm(theta.float(), phi.float().transpose(1, 2))         # (B, N, M) f32
    beta = torch.softmax(s, dim=-1)
    out = torch.bmm(beta.to(g.dtype).float(), g.float())              # f32 accumulation
    return out.to(theta.dtype)
