"""StyleGAN2's modulated convolutions and its thin-channel tail, plain PyTorch.

Counterpart of ``_modulate`` in :mod:`warpedganspace_tpu.models.stylegan2` and
of ``fused_section`` in :mod:`warpedganspace_tpu.ops.sg2_tail_pallas`
(reference ``models/StyleGAN2/model.py:148-282``). Activations are NCHW and
weights OIHW, the port's layouts.

Modulation uses the factorisation conv(x, w * s_b) == conv(x * s_b, w): every
sample shares one conv weight, and demodulation is the per-(sample,
out-channel) scalar d = rsqrt(sum_i s_i^2 * sum_kh,kw w^2 + 1e-8), applied to
the conv's output. :func:`modulate` computes (s, d) and :func:`modulated_conv`
applies them; the generator's blocks and the plain tail section both call
these two, so the section cannot drift from the blocks it replaces.

One tail *section* is one resolution block of the generator whose output has
C < 128 channels: 2C channels at (H, W) to C channels at (2H, 2W),

    x * s1 -> stride-2 transposed conv3x3 -> * d1 -> [1,3,3,1]^2 blur (gain 4)
    -> + nw1 * noise1 -> + b1 -> leaky 0.2 * sqrt 2                    (= mid)
    -> * s2 -> conv3x3 pad 1 -> * d2 -> + nw2 * noise2 -> + b2 -> leaky * sqrt 2   (= x2)
    -> * s3 -> ToRGB 1x1 (C -> 3) + rgb bias                           (= rgb)

:func:`fused_section_plain` writes every intermediate to memory; the CUDA
kernel of :mod:`warpedganspace_torch.ops.sg2_tail_cuda` writes only rgb (and
x2 when asked). The kernel computes the up-conv as four 3x3 polyphase convs
of the input; :func:`compose_up_weight` derives their weights from this
module's own transposed conv and blur.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from warpedganspace_torch.ops.fused_act import fused_leaky_relu
from warpedganspace_torch.ops.upfirdn2d import setup_filter, upfirdn2d

BLUR_KERNEL = (1.0, 3.0, 3.0, 1.0)
TAIL_CHANNELS = (16, 32, 64)   # a section's output channels C (its input has 2C): the
                               # widths the CUDA kernel is built for
TAIL_MAX_CHANNELS = 128        # blocks with fewer output channels than this form the tail


@functools.lru_cache(maxsize=None)
def blur_kernel(device: torch.device) -> torch.Tensor:
    """The upsampling blur on ``device``: [1,3,3,1] outer itself, unit sum
    times 4 (the upsampling factor squared)."""
    return setup_filter(BLUR_KERNEL, gain=4.0).to(device)


def modulate(weight: torch.Tensor, style: torch.Tensor, demodulate: bool = True):
    """Per-sample modulation factors of an OIHW ``weight`` for ``style`` (B, in),
    the output of the layer's modulation linear: (s, d) with s = style (B, in)
    and d (B, out), or None without demodulation."""
    if not demodulate:
        return style, None
    w2 = torch.sum(weight * weight, dim=(2, 3))                 # (out, in)
    return style, torch.rsqrt((style * style) @ w2.t() + 1e-8)


def modulated_conv(x, weight, s, d=None, upsample: bool = False):
    """x * s -> conv (or stride-2 transposed conv) -> * d [-> blur, pad (1, 1)]."""
    x = x * s[:, :, None, None]
    if upsample:
        x = F.conv_transpose2d(x, weight.transpose(0, 1), stride=2)
    else:
        x = F.conv2d(x, weight, padding=weight.shape[-1] // 2)
    if d is not None:
        x = x * d[:, :, None, None]
    if upsample:
        # Blur pad (1, 1) for a 3x3 kernel, factor 2, blur length 4.
        x = upfirdn2d(x, blur_kernel(x.device), pad=(1, 1))
    return x


def fused_section_plain(x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3,
                        n1, nw1, b1, n2, nw2, b2, rgb_b, want_x2: bool = True):
    """One tail section. x (B, 2C, H, W); ``w_up`` (C, 2C, 3, 3), ``w_same``
    (C, C, 3, 3), ``w_rgb`` (3, C, 1, 1); ``s1`` (B, 2C), ``d1``, ``s2``,
    ``d2``, ``s3`` (B, C); the noise maps ``n1``, ``n2`` (1, 1, 2H, 2W), shared
    by the batch, their weights ``nw1``, ``nw2`` one element each; the biases
    ``b1``, ``b2`` (C,) and ``rgb_b`` (3,).

    Returns ``(rgb, x2)``, rgb (B, 3, 2H, 2W) and x2 (B, C, 2H, 2W) the
    activation the next block takes, or only rgb without ``want_x2``. The
    skip of the block below is not added here."""
    m = modulated_conv(x, w_up, s1, d1, upsample=True)
    m = fused_leaky_relu(m + nw1.reshape(()) * n1, b1)
    x2 = modulated_conv(m, w_same, s2, d2)
    x2 = fused_leaky_relu(x2 + nw2.reshape(()) * n2, b2)
    rgb = modulated_conv(x2, w_rgb, s3) + rgb_b[None, :, None, None]
    return (rgb, x2) if want_x2 else rgb


@functools.lru_cache(maxsize=None)
def _phase_taps(device: torch.device) -> torch.Tensor:
    """(9 raw taps, 36 = 2 py x 2 px x 3 oy x 3 ox) float32 on ``device``: how
    much raw tap (ky, kx) of the 3x3 weight contributes to polyphase tap
    (oy, ox) of output phase (py, px), found by running this module's
    transposed conv and blur in float64 on a unit impulse at input pixel
    (1, 1) with each raw tap alone. Copied to ``device`` once: a copy per call
    would make the host wait for the device.

    Output pixel (2u + py, 2v + px) reads input pixel (u - 1 + oy, v - 1 + ox);
    for the impulse at (1, 1) that is output (4 - 2 oy + py, 4 - 2 ox + px)."""
    x = torch.zeros((1, 1, 3, 3), dtype=torch.float64)
    x[0, 0, 1, 1] = 1.0
    w = torch.eye(9, dtype=torch.float64).reshape(9, 1, 3, 3)    # (out = raw tap, in, 3, 3)
    resp = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
    resp = upfirdn2d(resp, setup_filter(BLUR_KERNEL, gain=4.0).double(), pad=(1, 1))[0]
    o = torch.arange(3)
    p = torch.arange(2)
    rows = 4 - 2 * o[None, :] + p[:, None]                       # (py, oy)
    taps = resp[:, rows[:, None, :, None], rows[None, :, None, :]]   # (9, py, px, oy, ox)
    return taps.reshape(9, 36).to(device=device, dtype=torch.float32)


def compose_up_weight(w_up: torch.Tensor) -> torch.Tensor:
    """(C, 2C, 3, 3) up-conv weight -> (2C, 4, 9, C) float32 polyphase weights:
    [ci][py * 2 + px][oy * 3 + ox][co], the stride-2 transposed conv and the
    blur as four 3x3 convs of the input, one per output phase. Elementwise
    products and sums only, so no TF32 setting can round them."""
    taps = _phase_taps(w_up.device)
    w = w_up.float().permute(1, 2, 3, 0).reshape(w_up.shape[1], 9, 1, w_up.shape[0])
    comp = (w * taps[None, :, :, None]).sum(1)                   # (2C, 36, C)
    return comp.reshape(w_up.shape[1], 4, 9, w_up.shape[0]).contiguous()


def tail_start(block_channels) -> int:
    """The index of the first block of the trailing run of synthesis blocks
    with fewer than ``TAIL_MAX_CHANNELS`` output channels (``block_channels``
    lists each block's), or ``len(block_channels)`` when the last block has
    more. Those blocks form the fused tail, one section each (the rule of the
    JAX package's ``tail_layout="pallas"``)."""
    start = len(block_channels)
    while start > 0 and block_channels[start - 1] < TAIL_MAX_CHANNELS:
        start -= 1
    return start
