"""StyleGAN2 (config-f, FFHQ 256/1024) generator, NCHW.

Counterpart of the generator in :mod:`warpedganspace_tpu.models.stylegan2`
(reference ``models/StyleGAN2/model.py``): a mapping network of PixelNorm and
``n_mlp`` equalized-lr linears (lr_mul 0.01), a constant 4x4 input, styled
modulated/demodulated convs with blurred 2x upsampling, fixed noise buffers,
skip-accumulated ToRGB, truncation and style mixing; and the discriminator
(reference model.py:453-503), which the WarpedGANSpace pipeline never runs but
which belongs to the model family.

As in the JAX package, the equalized-lr scales are folded into the stored
weights by the converters (the generator is frozen), and modulation uses the
factorisation conv(x, w * s_b) == conv(x * s_b, w): every sample shares one
conv weight, and demodulation is the per-(sample, out-channel) scalar
rsqrt(sum_i s_i^2 * sum_kh,kw w^2 + 1e-8), applied to the conv's output
(:func:`~warpedganspace_torch.ops.sg2_tail.modulate` and
:func:`~warpedganspace_torch.ops.sg2_tail.modulated_conv`). The stride-2
upsampling conv is ``conv_transpose2d`` followed by the 4x4 blur.

The trailing blocks with fewer than 128 output channels (the *tail*:
C = 64 at 512^2 and 32 at 1024^2 in config-f, none at 256^2, where the last
block has 128) go through
:func:`warpedganspace_torch.ops.sg2_tail_cuda.fused_section`, one call per
block: on a CUDA device one launch of the hand-written kernel, which fuses the
block's up-conv, same-conv and ToRGB; on the CPU the plain version of the same
algebra. The skip chain stays outside, as in the JAX package's
``tail_layout="pallas"`` route. Synthesis always takes the fixed noise
buffers, so the JAX package's fallback for random or explicit noise has no
counterpart here.

``remat`` recomputes blocks in the backward, as the JAX package's does:
``"full"`` every synthesis block, ``"tail"`` the blocks of < 128 output
channels, through ``torch.utils.checkpoint``. A tail block whose section runs
the kernel (a CUDA tensor) needs no wrapper for either: the kernel keeps no
intermediate, and its backward recomputes the plain section from the
section's operands, which is what ``"tail"`` asks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from warpedganspace_torch.ops.fused_act import fused_leaky_relu
from warpedganspace_torch.ops.sg2_tail import (BLUR_KERNEL, blur_kernel, modulate,
                                               modulated_conv, tail_start)
from warpedganspace_torch.ops.sg2_tail_cuda import fused_section
from warpedganspace_torch.ops.upfirdn2d import setup_filter, upfirdn2d


REMAT_CHOICES = ("off", "tail", "full")


def channels_dict(channel_multiplier: int = 2) -> dict[int, int]:
    """Per-resolution channel table (reference model.py:297-307)."""
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
            128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
            512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}


def _randn(shape, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32)


class EqualLinear(nn.Module):
    """x @ weight.T + bias, with lr_mul / sqrt(in) already folded into both."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), generator) / math.sqrt(in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ModulatedConv2d(nn.Module):
    """Styled conv: x * s -> conv (or stride-2 transposed conv) -> demod [-> blur]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, style_dim: int,
                 demodulate: bool = True, upsample: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            _randn((out_ch, in_ch, kernel, kernel), generator) / math.sqrt(in_ch * kernel * kernel))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0, generator=generator)
        self.demodulate = demodulate
        self.upsample = upsample

    def forward(self, x, style):
        s, d = modulate(self.weight, self.modulation(style), self.demodulate)
        return modulated_conv(x, self.weight, s, d, upsample=self.upsample)


class StyledConv(nn.Module):
    """Modulated conv + noise injection + fused bias/leaky ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, style_dim: int,
                 upsample: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel, style_dim, upsample=upsample,
                                    generator=generator)
        self.noise_weight = nn.Parameter(torch.zeros(()))
        self.act_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, style, noise):
        x = self.conv(x, style) + self.noise_weight * noise
        return fused_leaky_relu(x, self.act_bias)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB, plus the blur-upsampled skip of the block below."""

    def __init__(self, in_ch: int, style_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias[None, :, None, None]
        if skip is not None:
            out = out + self.upsample_skip(skip)
        return out

    @staticmethod
    def upsample_skip(skip):
        """The skip of the block below, blurred up to this block's resolution."""
        return upfirdn2d(skip, blur_kernel(skip.device), up=2, pad=(2, 1))


class StyleGAN2Generator(nn.Module):
    """The frozen StyleGAN2 generator; images are NCHW in roughly tanh range."""

    def __init__(self, resolution: int = 1024, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, shift_in_w_space: bool = False,
                 generator: torch.Generator | None = None, remat: str = "off"):
        super().__init__()
        if remat not in REMAT_CHOICES:
            raise ValueError(f"remat must be one of {REMAT_CHOICES}, got {remat!r}")
        self.remat = remat
        self.resolution = resolution
        self.style_dim = style_dim
        self.shift_in_w_space = shift_in_w_space
        ch = channels_dict(channel_multiplier)
        self.mapping = nn.ModuleList(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, generator=generator)
            for _ in range(n_mlp))
        self.const_input = nn.Parameter(_randn((1, ch[4], 4, 4), generator))
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim, generator=generator)
        self.to_rgb1 = ToRGB(ch[4], style_dim, generator=generator)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True,
                                         generator=generator))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim, generator=generator))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, generator=generator))
            in_ch = out_ch
        self.noises = nn.Module()
        for i in range(self.num_layers):
            size = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise_{i}", _randn((1, 1, size, size), generator))

    @property
    def dim_z(self) -> int:
        return 512

    @property
    def log_size(self) -> int:
        return int(math.log2(self.resolution))

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    # ------------------------------------------------------------------ mapping
    def style(self, z):
        """Mapping network Z -> W: PixelNorm, then linears with fused leaky ReLU."""
        x = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + 1e-8)
        for layer in self.mapping:
            x = fused_leaky_relu(layer(x), None)
        return x

    def get_w(self, z):
        return self.style(z)

    # ---------------------------------------------------------------- synthesis
    def synthesis(self, latent):
        """Per-layer W latents (B, n_latent, 512) -> NCHW image (B, 3, H, W),
        with the fixed noise buffers (the reference's randomize_noise=False)."""
        b = latent.shape[0]
        noise = [getattr(self.noises, f"noise_{i}") for i in range(self.num_layers)]
        out = self.const_input.expand(b, -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        lo = self.tail_start()
        for idx in range(len(self.to_rgbs)):
            lat3 = latent[:, 1 + 2 * idx: 4 + 2 * idx]
            n_up, n_same = noise[2 * idx + 1], noise[2 * idx + 2]
            block = self._block if idx < lo else self._tail_block
            kernel_route = idx >= lo and out.is_cuda
            if not kernel_route and (self.remat == "full" or (
                    self.remat == "tail" and self.convs[2 * idx].conv.weight.shape[0] < 128)):
                out, skip = checkpoint(block, idx, out, skip, lat3, n_up, n_same,
                                       use_reentrant=False)
            else:
                out, skip = block(idx, out, skip, lat3, n_up, n_same)
        return skip

    def _block(self, idx, out, skip, lat3, n_up, n_same):
        """Synthesis block ``idx`` of the head: up-conv, same-conv, ToRGB."""
        out = self.convs[2 * idx](out, lat3[:, 0], n_up)
        out = self.convs[2 * idx + 1](out, lat3[:, 1], n_same)
        return out, self.to_rgbs[idx](out, lat3[:, 2], skip)

    def _tail_block(self, idx, out, skip, lat3, n_up, n_same):
        """Synthesis block ``idx`` of the tail: one fused section (``out`` is
        None after the last block, whose x2 nothing reads)."""
        conv_up, conv, to_rgb = self.convs[2 * idx], self.convs[2 * idx + 1], self.to_rgbs[idx]
        want_x2 = idx < len(self.to_rgbs) - 1
        s1, d1 = modulate(conv_up.conv.weight, conv_up.conv.modulation(lat3[:, 0]))
        s2, d2 = modulate(conv.conv.weight, conv.conv.modulation(lat3[:, 1]))
        s3 = to_rgb.conv.modulation(lat3[:, 2])
        res = fused_section(
            out.contiguous(), conv_up.conv.weight, conv.conv.weight, to_rgb.conv.weight,
            s1, d1, s2, d2, s3, n_up, conv_up.noise_weight, conv_up.act_bias,
            n_same, conv.noise_weight, conv.act_bias, to_rgb.bias, want_x2=want_x2)
        rgb, out = res if want_x2 else (res, None)
        return out, rgb + to_rgb.upsample_skip(skip)

    def tail_start(self) -> int:
        """The first synthesis block of the fused tail (``len(self.to_rgbs)``
        when there is none): see :func:`warpedganspace_torch.ops.sg2_tail.tail_start`."""
        return tail_start([self.convs[2 * idx].conv.weight.shape[0]
                           for idx in range(len(self.to_rgbs))])

    def forward(self, styles, input_is_latent: bool = False, inject_index: int | None = None,
                truncation: float = 1.0, truncation_latent=None):
        """Full forward with style mixing and truncation (reference :359-403).

        ``styles`` is a list of (B, 512) latents. With two styles the second
        takes over at ``inject_index`` (default n_latent // 2).
        """
        if not input_is_latent:
            styles = [self.style(s) for s in styles]
        if truncation < 1.0:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
        if len(styles) < 2:
            latent = styles[0][:, None, :].expand(-1, self.n_latent, -1)
        else:
            if inject_index is None:
                inject_index = self.n_latent // 2
            latent = torch.cat([
                styles[0][:, None, :].expand(-1, inject_index, -1),
                styles[1][:, None, :].expand(-1, self.n_latent - inject_index, -1)], dim=1)
        return self.synthesis(latent)

    def apply(self, z, shift=None, latent_is_w: bool = False):
        """The uniform contract (reference StyleGAN2Wrapper.forward): shifts live
        in W when ``shift_in_w_space``, else in Z."""
        if self.shift_in_w_space:
            w = z if latent_is_w else self.style(z)
            if shift is not None:
                w = w + shift
            return self.forward([w], input_is_latent=True)
        if shift is not None:
            z = z + shift
        return self.forward([z], input_is_latent=False)


# --------------------------------------------------------------- discriminator
class ConvLayer(nn.Module):
    """[blur +] equalized-lr conv [+ fused bias/leaky ReLU] (reference ConvLayer,
    model.py:424-450), the scale folded into ``weight``. Downsampling blurs
    with pad ((p+1)//2, p//2), p = len(blur) - 2 + (k - 1), then convolves at
    stride 2 without padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, downsample: bool = False,
                 activate: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            _randn((out_ch, in_ch, kernel, kernel), generator) / math.sqrt(in_ch * kernel * kernel))
        if activate:
            self.act_bias = nn.Parameter(torch.zeros(out_ch))
        else:
            self.register_parameter("act_bias", None)
        self.downsample = downsample

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.downsample:
            pb = (len(BLUR_KERNEL) - 2) + (k - 1)
            x = upfirdn2d(x, setup_filter(BLUR_KERNEL).to(x.device), pad=((pb + 1) // 2, pb // 2))
            x = F.conv2d(x, self.weight, stride=2)
        else:
            x = F.conv2d(x, self.weight, padding=k // 2)
        return x if self.act_bias is None else fused_leaky_relu(x, self.act_bias)


class ResBlock(nn.Module):
    """conv -> downsampling conv, plus a blurred 1x1 downsampling skip; the sum
    scaled by 1/sqrt(2) (reference model.py:439-450)."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, generator=generator)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, generator=generator)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False,
                              generator=generator)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


def minibatch_stddev(x, group_size: int = 4, eps: float = 1e-8):
    """Append the minibatch-stddev feature map (reference model.py:489-495):
    samples i and i + B/G share a group of G = min(B, group_size), and every
    sample gets the mean over (C, H, W) of its group's population stddev."""
    b, c, h, w = x.shape
    group = min(b, group_size)
    if b % group:
        raise ValueError(f"the batch {b} is not a multiple of the stddev group {group}")
    y = x.reshape(group, b // group, c, h, w)
    std = torch.sqrt(y.var(dim=0, unbiased=False) + eps)      # (B/G, C, H, W)
    s = std.mean(dim=(1, 2, 3), keepdim=True)                   # (B/G, 1, 1, 1)
    return torch.cat([x, s.repeat(group, 1, h, w)], dim=1)


class StyleGAN2Discriminator(nn.Module):
    """(B, 3, H, W) images -> (B, 1) realness logits (reference Discriminator,
    model.py:453-503). The head flattens the 4x4 map in NCHW order, which is
    the reference's own, so its first linear needs no permutation."""

    def __init__(self, resolution: int = 1024, channel_multiplier: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.resolution = resolution
        ch = channels_dict(channel_multiplier)
        self.conv_in = ConvLayer(3, ch[resolution], 1, generator=generator)
        self.blocks = nn.ModuleList()
        in_ch = ch[resolution]
        for i in range(int(math.log2(resolution)), 2, -1):
            self.blocks.append(ResBlock(in_ch, ch[2 ** (i - 1)], generator=generator))
            in_ch = ch[2 ** (i - 1)]
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3, generator=generator)
        self.final_linear1 = EqualLinear(ch[4] * 16, ch[4], generator=generator)
        self.final_linear2 = EqualLinear(ch[4], 1, generator=generator)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.blocks:
            h = block(h)
        h = self.final_conv(minibatch_stddev(h))
        h = fused_leaky_relu(self.final_linear1(h.flatten(1)), None)
        return self.final_linear2(h)
