"""Uniform generator contract.

Counterpart of :mod:`warpedganspace_tpu.models.api`. The reference wraps every
GAN behind one interface (models/gan_load.py): ``G(z, shift=None)`` returns
an image, with ``G.dim_z`` and, for StyleGAN2, ``G.get_w(z)``. Here that is an
``nn.Module`` around the frozen network:

- ``G(z, shift=None, latent_is_w=False, y=None)`` -> NCHW image in roughly
  tanh range; ``y`` (BigGAN's classes, one per row) is drawn from z when not
  given;
- ``G.get_w(z)`` -> the mapping network for StyleGAN2, identity otherwise;
- ``dim_z``, ``resolution``, ``shift_in_w_space``.

:func:`cast_params_bf16` is the mixed-precision policy: a bfloat16 copy of the
frozen weights for rendering, while the float32 original maps Z to W.
"""
from __future__ import annotations

import copy

import torch
from torch import nn


class GeneratorBundle(nn.Module):
    def __init__(self, name: str, net: nn.Module, dim_z: int, resolution: int,
                 shift_in_w_space: bool = False):
        super().__init__()
        self.name = name
        self.net = net
        self.dim_z = dim_z
        self.resolution = resolution
        self.shift_in_w_space = shift_in_w_space

    def forward(self, z, shift=None, latent_is_w: bool = False, y=None):
        if y is None:
            return self.net.apply(z, shift, latent_is_w=latent_is_w)
        return self.net.apply(z, shift, y=y, latent_is_w=latent_is_w)

    def get_w(self, z):
        get_w = getattr(self.net, "get_w", None)
        return z if get_w is None else get_w(z)


def cast_params_bf16(G: nn.Module) -> nn.Module:
    """A copy of the frozen ``G`` with every float32 parameter and buffer in bfloat16."""
    G16 = copy.deepcopy(G)
    for t in list(G16.parameters()) + list(G16.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.to(torch.bfloat16)
    return G16
