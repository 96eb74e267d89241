"""Operand rounding: the identity for the reference, one precision below the
configuration's for its control. A control rounds every operand of a
convolution or a linear (activations and weights) as a kernel computing in
that precision would, accumulating in float32, and rounds the gradient that
flows back through each such operand in the same way: bfloat16 both ways
below float32; below bfloat16, float8 as float8 training computes (e4m3
forward, e5m2 backward, one scale per tensor at its absolute maximum)."""
from __future__ import annotations

import torch


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _scaled(fmt: torch.dtype):
    top = torch.finfo(fmt).max

    def rnd(x: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(x.abs().amax().float(), min=1e-30) / top
        return (x / scale).to(fmt).to(x.dtype) * scale.to(x.dtype)
    return rnd


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad), None, None


def _rounding(fwd, bwd):
    def q(x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x, fwd, bwd)
    return q


bf16 = _rounding(_to_bf16, _to_bf16)
fp8 = _rounding(_scaled(torch.float8_e4m3fn), _scaled(torch.float8_e5m2))

BELOW = {"float32": bf16, "bfloat16": fp8}
STATED = {"float32": exact, "bfloat16": bf16}


def no_tf32():
    """Plain float32 products: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
