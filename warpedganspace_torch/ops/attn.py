"""SA-GAN spatial attention (BigGAN's non-local block), plain PyTorch.

Counterpart of ``_jnp_attention`` in :mod:`warpedganspace_tpu.ops.attn_pallas`
(reference ``models/BigGAN/layers.py:141-166``): per sample,
``softmax(theta @ phi^T) @ g`` with no scale on the logits. The layout is the
JAX package's: theta (B, N, dk), phi (B, M, dk), g (B, M, dv) -> (B, N, dv).

These are the plain versions of the two CUDA kernels in
:mod:`warpedganspace_torch.ops.attn_cuda` (forward and backward); they
materialize the (B, N, M) attention matrix, which the kernels never do.
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


def sa_attention_bwd_plain(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
                           ct: torch.Tensor):
    """Gradients of :func:`sa_attention_plain` for the cotangent ``ct`` of its output.

    Counterpart of ``_attn_bwd_kernel`` in :mod:`warpedganspace_tpu.ops.attn_pallas`,
    written out: beta = softmax(theta phi^T) is recomputed in float32,
    dbeta = ct g^T, ds = beta * (dbeta - rowsum(dbeta * beta)), and
    dtheta = ds phi, dphi = ds^T theta, dg = beta^T ct. As there, ds and beta are
    rounded to the storage type before their products and every product is
    accumulated in float32. Returns (dtheta, dphi, dg) in the operands' types.

    This is the plain version of the backward CUDA kernel in
    :mod:`warpedganspace_torch.ops.attn_cuda`; it materializes four (B, N, M)
    matrices, which the kernel never does.
    """
    th, ph, gf, ctf = theta.float(), phi.float(), g.float(), ct.float()
    beta = torch.softmax(torch.bmm(th, ph.transpose(1, 2)), dim=-1)     # (B, N, M) f32
    dbeta = torch.bmm(ctf, gf.transpose(1, 2))
    ds = beta * (dbeta - torch.sum(dbeta * beta, dim=-1, keepdim=True))
    ds = ds.to(phi.dtype).float()
    dtheta = torch.bmm(ds, ph)
    dphi = torch.bmm(ds.transpose(1, 2), th)
    dg = torch.bmm(beta.to(ct.dtype).float().transpose(1, 2), ctf)
    return dtheta.to(theta.dtype), dphi.to(phi.dtype), dg.to(g.dtype)
