"""ProgGAN (Progressive Growing of GANs) 1024x1024 CelebA-HQ generator, NCHW.

Counterpart of :mod:`warpedganspace_tpu.models.proggan` (reference
``models/ProgGAN/model.py``): a fixed chain of 18 blocks, each PixelNorm ->
(optional 2x nearest-up) -> conv3x3 (no bias) -> WScale (one learned scalar
scale and a per-channel bias) -> LeakyReLU(0.2) (:34-62), channels 512...16,
then the output head PixelNorm -> conv1x1 -> WScale (:65-95). The input is a
(B, 512) latent taken as a 1x1 map; the first block pads by 3, so its 4x4
conv gives a 4x4 map.

The blocks of 128 and more channels (the *head* of the chain) are plain
PyTorch: cuDNN convolutions between elementwise passes, as the JAX package
leaves them to XLA. The <=64-channel blocks at 256^2..1024^2 (the *tail*) go
through :func:`warpedganspace_torch.ops.proggan_tail_cuda.proggan_tail`: on a
CUDA device one launch of the hand-written kernel per resolution section.

Structural rule: the tail is fused when the chain ends in the pattern
``tail_sections_from_blocks`` recognises (the first up block with at most 128
input channels that halves them, then alternating up 2C -> C and same C -> C
blocks with halving C in {64, 32, 16}); the reference 1024^2 chain does, with
12 head blocks and three sections. A chain without such a suffix runs every
block plain, as the JAX package's does. The JAX package's TPU layout
devices (the s2d and fold-x tail layouts, the merged 4x4 up-conv, the s2d
output layout) are not carried over.

The generator is frozen; training differentiates it with respect to the
shift. ``remat`` recomputes blocks in the backward, as the JAX package's
does: ``"full"`` every block, ``"tail"`` the blocks of < 128 output channels,
through ``torch.utils.checkpoint``. On a CUDA tensor the tail needs no
wrapper for either: the kernel keeps no intermediate, and its backward
recomputes the plain section from the section's operands, which is what
``"tail"`` asks. On the CPU the plain tail is wrapped whole.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from warpedganspace_torch.ops.proggan_tail import (block_plain, head_plain,
                                                   tail_sections_from_blocks)
from warpedganspace_torch.ops.proggan_tail_cuda import proggan_tail

REMAT_CHOICES = ("off", "tail", "full")
# (kernel, padding, upsample) of the 18 feature blocks (model.py:67-84).
_BLOCK_SPECS = [(4, 3, False), (3, 1, False)] + [(3, 1, up) for up in [True, False] * 8]
# The reference 1024^2 channel chain: N + 1 entries for N blocks.
_CHANNELS = [512, 512, 512, 512, 512, 512, 512, 512, 512, 256, 256, 128, 128, 64, 64, 32, 32,
             16, 16]


class WScaleConv(nn.Module):
    """A bias-free conv weight (OIHW) with its WScale: one scalar ``scale`` and
    a per-channel ``bias``. Random init as the JAX package's: N(0, 0.02)
    weights, scale 1, bias 0."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, generator):
        super().__init__()
        self.weight = nn.Parameter(0.02 * torch.randn((out_ch, in_ch, kernel, kernel),
                                                      generator=generator))
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(out_ch))


class ProgGANGenerator(nn.Module):
    """The frozen ProgGAN generator; images are NCHW.

    ``channels`` overrides the reference 1024^2 chain (N + 1 entries for N
    feature blocks): depth, and with it the output resolution, follows the
    chain, so a short one gives a small generator. ``channels[0]`` must equal
    ``dim_z``.
    """

    def __init__(self, dim_z: int = 512, resolution: int | None = None, channels=None,
                 generator: torch.Generator | None = None, remat: str = "off"):
        super().__init__()
        if remat not in REMAT_CHOICES:
            raise ValueError(f"remat must be one of {REMAT_CHOICES}, got {remat!r}")
        self.remat = remat
        channels = list(_CHANNELS if channels is None else channels)
        if channels[0] != dim_z:
            raise ValueError(f"channels[0]={channels[0]} must equal dim_z={dim_z}")
        if not 2 <= len(channels) <= len(_BLOCK_SPECS) + 1:
            raise ValueError(f"a ProgGAN chain has 1 to {len(_BLOCK_SPECS)} blocks, "
                             f"got {len(channels) - 1}")
        self.specs = _BLOCK_SPECS[: len(channels) - 1]
        chain_resolution = 4 * 2 ** sum(up for _, _, up in self.specs)
        if resolution is not None and resolution != chain_resolution:
            raise ValueError(f"a chain of {len(self.specs)} blocks renders "
                             f"{chain_resolution}^2, not {resolution}^2")
        self.dim_z = dim_z
        self.resolution = chain_resolution
        self.blocks = nn.ModuleList(
            WScaleConv(cin, cout, k, generator)
            for (k, _, _), cin, cout in zip(self.specs, channels[:-1], channels[1:]))
        self.out = WScaleConv(channels[-1], 3, 1, generator)     # the RGB head
        # The chain is fixed from here on, and the sections name blocks, not tensors.
        self._tail_split = tail_sections_from_blocks(list(self.blocks), self.specs)

    def tail_split(self):
        """``(n_head_blocks, sections)`` of this chain (see the module docstring)."""
        return self._tail_split

    def apply(self, z, shift=None, latent_is_w: bool = False):
        """G(z + shift) -> (B, 3, R, R) (ProgGANWrapper.forward,
        models/gan_load.py:109-120; model.py:86-95). ProgGAN has no W space:
        ``latent_is_w`` is part of the uniform contract and is ignored."""
        if shift is not None:
            z = z + shift
        x = z[:, :, None, None]                          # the (B, 512, 1, 1) seed
        n_head, sections = self.tail_split()
        for (_, pad, up), block in zip(self.specs[:n_head], self.blocks[:n_head]):
            if self.remat == "full" or (self.remat == "tail" and block.weight.shape[0] < 128):
                x = checkpoint(block_plain, x, block.weight, block.bias, block.scale, up=up,
                               padding=pad, use_reentrant=False)
            else:
                x = block_plain(x, block.weight, block.bias, block.scale, up=up, padding=pad)
        if not sections:
            return head_plain(x, self.out.weight, self.out.bias, self.out.scale)
        if self.remat != "off" and not x.is_cuda:
            return checkpoint(proggan_tail, x.contiguous(), sections, self.out,
                              use_reentrant=False)
        return proggan_tail(x.contiguous(), sections, self.out)

    forward = apply
