"""upfirdn2d: upsample -> pad -> FIR filter -> downsample, NCHW, in plain PyTorch.

Counterpart of :mod:`warpedganspace_tpu.ops.upfirdn2d` (reference
``op/upfirdn2d.py::upfirdn2d_native``):

1. zero-stuff every sample with (up-1) zeros *after* it, the last one
   included, so each dimension grows to in*up;
2. pad the edges, pad0 before and pad1 after (negative values crop);
3. convolve with the FIR kernel (a depthwise correlation with the flipped kernel);
4. keep every ``down``-th sample.

Output size per dimension: (in*up + pad0 + pad1 - kernel) // down + 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Apply upfirdn to an NCHW tensor, the same on both spatial axes.

    ``pad`` is (pad0, pad1); ``kernel`` (kh, kw) is not flipped.
    """
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kh, kw = kernel.shape
    weight = torch.flip(kernel, (0, 1)).to(x.dtype).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    return F.conv2d(x, weight, stride=down, groups=c)


def setup_filter(kernel, gain: float = 1.0) -> torch.Tensor:
    """Outer-product a 1D filter, normalise to unit sum, scale by ``gain``."""
    k = torch.as_tensor(kernel, dtype=torch.float32)
    if k.dim() == 1:
        k = torch.outer(k, k)
    return k / k.sum() * gain
