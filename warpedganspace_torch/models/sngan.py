"""SNGAN ResNet generator (MNIST 32x32 / AnimeFaces 64x64), NCHW.

Counterpart of :mod:`warpedganspace_tpu.models.sngan` (reference
``models/SNGAN/sn_gen_resnet.py``): a dense layer from z to a (C0, 4, 4) seed
in C order, which is NCHW as it is; a chain of residual up blocks, eval
BatchNorm -> ReLU -> nearest 2x up -> conv3x3 -> BatchNorm -> ReLU -> conv3x3,
plus a bypass that upsamples and, only where the channels change, convolves
(:24-57); and the head BatchNorm -> ReLU -> conv3x3 -> tanh (:99-108).
Configs (:9-12): ``SNGAN_MNIST`` channels (256,)*4 at 32^2 with one image
channel, ``SNGAN_AnimeFaces`` (1024, 512, 256, 128, 64) at 64^2 with three;
dim_z = 128 for both.

The blocks upsample, then convolve. The JAX package merges each nearest-up
and 3x3 conv into one 4x4 kernel (``ops/s2d.py``), a TPU layout device; the
tests show the two agree.

Inference only (the generator is frozen; the reference trainer sets
G.eval()), so BatchNorm always uses its stored statistics. With bfloat16
parameters its affine is formed in the parameters' type and applied as one
``x * a + b``, as the JAX package does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

SNGAN_CONFIGS = {
    "SNGAN_MNIST": dict(channels=(256, 256, 256, 256), img_size=32, image_channels=1),
    "SNGAN_AnimeFaces": dict(channels=(1024, 512, 256, 128, 64), img_size=64,
                             image_channels=3),
}
DIM_Z = 128
SEED_DIM = 4


def _xavier_uniform_(w: torch.Tensor, generator, gain: float = 1.0) -> None:
    """torch ``xavier_uniform_`` from ``generator`` for an OIHW conv or (out, in) linear."""
    receptive = w[0, 0].numel() if w.dim() > 2 else 1
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)


def _conv(in_ch: int, out_ch: int, generator, gain: float = 1.0) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
    _xavier_uniform_(conv.weight, generator, gain)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


class EvalBatchNorm(nn.Module):
    """BatchNorm2d at eval: the stored statistics, names as ``nn.BatchNorm2d``'s."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps)
        if x.dtype != torch.float32:
            a = inv * self.weight
            b = self.bias - self.running_mean * a
            return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        return ((x - self.running_mean.view(shape)) * inv.view(shape) * self.weight.view(shape)
                + self.bias.view(shape))


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    """One residual up block (sn_gen_resnet.py:24-57)."""

    def __init__(self, in_ch: int, out_ch: int, generator):
        super().__init__()
        self.bn1 = EvalBatchNorm(in_ch)
        self.conv1 = _conv(in_ch, out_ch, generator, gain=math.sqrt(2.0))
        self.bn2 = EvalBatchNorm(out_ch)
        self.conv2 = _conv(out_ch, out_ch, generator, gain=math.sqrt(2.0))
        self.bypass = _conv(in_ch, out_ch, generator) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(_up(F.relu(self.bn1(x))))
        h = self.conv2(F.relu(self.bn2(h)))
        bypass = _up(x)
        return h + (bypass if self.bypass is None else self.bypass(bypass))


class SNGANGenerator(nn.Module):
    """The frozen SNGAN generator; images are NCHW in tanh range.

    Random init as the JAX package's ``init``: xavier-uniform weights (gain
    sqrt 2 for the blocks' two convs), zero biases, unit BatchNorm, drawn from
    ``generator``."""

    def __init__(self, channels, img_size: int, image_channels: int, dim_z: int = DIM_Z,
                 generator: torch.Generator | None = None):
        super().__init__()
        channels = tuple(channels)
        if img_size != SEED_DIM * 2 ** (len(channels) - 1):
            raise ValueError(f"{len(channels) - 1} up blocks from a {SEED_DIM}^2 seed render "
                             f"{SEED_DIM * 2 ** (len(channels) - 1)}^2, not {img_size}^2")
        self.channels = channels
        self.dim_z = dim_z
        self.resolution = img_size
        self.image_channels = image_channels
        self.dense = nn.Linear(dim_z, channels[0] * SEED_DIM ** 2)
        _xavier_uniform_(self.dense.weight, generator)
        with torch.no_grad():
            self.dense.bias.zero_()
        self.blocks = nn.ModuleList(ResBlock(cin, cout, generator)
                                    for cin, cout in zip(channels[:-1], channels[1:]))
        self.out_bn = EvalBatchNorm(channels[-1])
        self.out_conv = _conv(channels[-1], image_channels, generator)

    @classmethod
    def from_gan_type(cls, gan_type: str, generator: torch.Generator | None = None):
        return cls(**SNGAN_CONFIGS[gan_type], generator=generator)

    def apply(self, z, shift=None, latent_is_w: bool = False):
        """G(z + shift) -> (B, C, R, R) (SNGANWrapper.forward,
        models/gan_load.py:21-28). SNGAN has no W space: ``latent_is_w`` is
        part of the uniform contract and is ignored."""
        if shift is not None:
            z = z + shift
        x = self.dense(z).view(z.shape[0], self.channels[0], SEED_DIM, SEED_DIM)
        for block in self.blocks:
            x = block(x)
        return torch.tanh(self.out_conv(F.relu(self.out_bn(x))))

    forward = apply
