"""ProgGAN's 1024x1024 generator (CelebA-HQ), plain, from the reference layout.

The equations of ``models/ProgGAN/model.py``: the (B, 512) code as a 1x1 map;
18 blocks, each PixelNorm -> [nearest 2x upsampling] -> conv (no bias; the
first 4x4 with padding 3, the rest 3x3 with padding 1) -> WScale (x * scale +
b) -> LeakyReLU(0.2); the RGB head PixelNorm -> conv1x1 -> WScale.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.quant import exact


def pixel_norm(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class ProgGAN:
    def __init__(self, sd: dict, cfg: dict, q=exact):
        self.sd, self.cfg, self.q = sd, cfg, q
        self.n_blocks = len(cfg["channels"]) - 1

    def _conv(self, x, name, padding):
        x = F.conv2d(self.q(x), self.q(self.sd[name + ".conv.weight"]), padding=padding)
        scale = self.sd[name + ".wscale.scale"].reshape(())
        return x * scale + self.sd[name + ".wscale.b"].reshape(1, -1, 1, 1)

    def chain(self, z):
        x = z[:, :, None, None]
        for j in range(self.n_blocks):
            x = pixel_norm(x)
            if j >= 2 and j % 2 == 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = F.leaky_relu(self._conv(x, f"features.{j}", 3 if j == 0 else 1), 0.2)
        return self._conv(pixel_norm(x), "output", 0)

    def latent(self, z):
        """The space the paths live in: Z."""
        return z

    def render(self, latent, shift):
        return self.chain(latent + shift)
