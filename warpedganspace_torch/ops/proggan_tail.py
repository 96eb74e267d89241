"""ProgGAN's thin-channel tail (the <=64-channel blocks), plain PyTorch.

Counterpart of ``_tail_jnp`` and ``tail_sections_from_blocks`` in
:mod:`warpedganspace_tpu.ops.proggan_tail_pallas` (reference
``models/ProgGAN/model.py:65-95``). One *section* takes 2C channels at R/2 to
C channels at R:

    PixelNorm -> nearest 2x up -> conv3x3 pad 1 (2C -> C) -> WScale -> LeakyReLU(0.2)
    -> PixelNorm -> conv3x3 pad 1 (C -> C) -> WScale -> LeakyReLU(0.2)

and the last section ends in the RGB head, PixelNorm -> conv1x1 (C -> 3) ->
WScale with no activation. WScale is ``x * scale + bias`` with one learned
scalar and a per-channel bias; the convolutions have no bias of their own.

Activations are NCHW and weights OIHW, the port's layouts. These functions are
the plain versions of the CUDA kernel in
:mod:`warpedganspace_torch.ops.proggan_tail_cuda`; they write every
intermediate (the 4x upsampled input, the mid activation, the normalised
copies) to memory, which the kernel never does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2
PN_EPS = 1e-8
TAIL_CHANNELS = (16, 32, 64)   # a section's output channels C (its input has 2C): the
                               # widths the CUDA kernel is built for


def pixel_norm(x: torch.Tensor, eps: float = PN_EPS) -> torch.Tensor:
    """x / sqrt(mean_c(x^2) + eps) over the channel dimension of an NCHW tensor
    (reference models/ProgGAN/model.py:12-18)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def wscale(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x * scale + bias``: one scalar scale, one bias per channel."""
    return x * scale.reshape(()) + bias[None, :, None, None]


def block_plain(x, weight, bias, scale, up: bool, padding: int = 1):
    """One ProgGAN feature block: PixelNorm -> [nearest 2x up] -> conv (no
    bias) -> WScale -> LeakyReLU(0.2)."""
    x = pixel_norm(x)
    if up:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    x = wscale(F.conv2d(x, weight, padding=padding), scale, bias)
    return F.leaky_relu(x, LEAKY_SLOPE)


def head_plain(x, weight, bias, scale):
    """The RGB head: PixelNorm -> conv1x1 -> WScale, no activation."""
    return wscale(F.conv2d(pixel_norm(x), weight), scale, bias)


def fused_section_plain(x, w_up, b_up, s_up, w_same, b_same, s_same, head=None):
    """One tail section. x (B, 2C, H, W); ``w_up`` (C, 2C, 3, 3), ``w_same``
    (C, C, 3, 3), biases (C,), scales of one element. Returns (B, C, 2H, 2W),
    or (B, 3, 2H, 2W) when ``head = (w_out (3, C, 1, 1), b_out (3,), s_out)``
    is given."""
    x = block_plain(x, w_up, b_up, s_up, up=True)
    x = block_plain(x, w_same, b_same, s_same, up=False)
    if head is not None:
        x = head_plain(x, *head)
    return x


def merge_up_taps(w_up: torch.Tensor) -> torch.Tensor:
    """(C, 2C, 3, 3) up-conv weight -> (2, 2, 2, 2, C, 2C) float32 merged taps
    ``[pi][pj][a][b]``: nearest 2x up followed by the 3x3 conv is, for each
    parity (pi, pj) of the output pixel (2 A + pi, 2 V + pj) of a tile whose
    origin is one pixel before an even image row and column, a 2x2 conv of the
    input pixels (A + a, V + b) from one pixel before the tile's half origin.
    Along one axis, parity 0 (an odd image row) takes taps 0 + 1 then tap 2,
    parity 1 (an even row) tap 0 then taps 1 + 2. Sums only, in float32, so no
    TF32 setting can round them; the bf16 CUDA kernel reads them."""
    w = w_up.float()

    def axis(t, dim):
        t0, t1, t2 = t.unbind(dim)
        return torch.stack([torch.stack([t0 + t1, t2]), torch.stack([t0, t1 + t2])])

    rows = axis(w, 2)                                  # (pi, a, C, 2C, kx)
    both = axis(rows, 4)                               # (pj, b, pi, a, C, 2C)
    return both.permute(2, 0, 3, 1, 4, 5).contiguous()


def _wbs(block):
    return block.weight, block.bias, block.scale


def proggan_tail_plain(x, sections, out):
    """Every section, then the RGB head. ``sections`` is the list of
    ``(up_block, same_block)`` pairs that :func:`tail_sections_from_blocks`
    returns; a block, like ``out``, carries ``weight``, ``bias`` and ``scale``."""
    for i, (up, same) in enumerate(sections):
        head = _wbs(out) if i == len(sections) - 1 else None
        x = fused_section_plain(x, *_wbs(up), *_wbs(same), head=head)
    return x


def tail_sections_from_blocks(blocks, block_specs):
    """Split a ProgGAN block list at the entry of the fused tail: the first up
    block with cin <= 128 and cout = cin / 2, after which the chain must
    alternate (up 2C -> C, same C -> C) with halving C down to the last block,
    every C one of ``TAIL_CHANNELS``.

    ``blocks`` carry OIHW ``weight``s, ``block_specs`` are their
    (kernel, padding, upsample) triples. Returns ``(n_head_blocks, sections)``
    with ``sections`` a list of ``(up_block, same_block)``, or
    ``(len(blocks), [])`` when the chain has no such suffix."""
    n = len(blocks)
    entry = None
    for i, (block, (_, _, up)) in enumerate(zip(blocks, block_specs)):
        cout, cin = block.weight.shape[:2]
        if up and cin <= 2 * max(TAIL_CHANNELS) and cout * 2 == cin:
            entry = i
            break
    if entry is None or (n - entry) % 2 != 0:
        return n, []
    sections = []
    c = None
    for j in range(entry, n, 2):
        up_block, same_block = blocks[j], blocks[j + 1]
        wu, ws = tuple(up_block.weight.shape), tuple(same_block.weight.shape)
        cj = wu[0]
        ok = (block_specs[j][2] and not block_specs[j + 1][2]
              and wu == (cj, 2 * cj, 3, 3) and ws == (cj, cj, 3, 3)
              and cj in TAIL_CHANNELS
              and (c is None or cj * 2 == c))
        if not ok:
            return n, []
        sections.append((up_block, same_block))
        c = cj
    return entry, sections
