"""BigGAN class-conditional ImageNet generator (ch=96, hier-z), NCHW.

Counterpart of the generator in :mod:`warpedganspace_tpu.models.biggan`
(reference ``models/BigGAN/BigGAN.py`` + ``layers.py``) under the shipped
``generator_config.json`` (G_ch=96, dim_z=120, hier=True, G_shared=True,
shared_dim=128, attention at 64x64, 128x128 output):

- Hierarchical latent: z is split into ``num_slots`` chunks; chunk 0 feeds the
  first linear, each later chunk is concatenated with the shared class
  embedding to condition one block (BigGAN.py:102-111, 224-229).
- GBlock: ccbn -> ReLU -> 2x nearest-up -> conv3x3 -> ccbn -> ReLU -> conv3x3,
  plus a 1x1 shortcut on the upsampled input (layers.py:372-405). The JAX
  package's merged 4x4 dilated conv and low-resolution shortcut are exact
  rewrites of this plain form for the TPU and are not carried over.
- ccbn in eval mode: batch-norm with stored statistics (no affine), then the
  per-sample class-conditional gain (1 + Linear(y)) and bias Linear(y)
  (layers.py:275-326). The generator is frozen, so stored statistics are
  always used.
- SA-GAN attention (layers.py:141-166); the softmax(theta phi^T) g chain goes
  through :func:`warpedganspace_torch.ops.attn_cuda.sa_attention`: on a CUDA
  device the hand-written forward kernel and, under autograd (training
  differentiates the frozen generator with respect to the shift), the
  hand-written backward kernel.
- Output: affine BN -> ReLU -> conv3x3 -> tanh (BigGAN.py:170-174, 242-243).

Every ``CCBN.forward`` is the span ``wgs.biggan.ccbn`` and every
``Attention.forward`` (its projections, pools, transposes, the kernel, the
output conv and the residual) the span ``wgs.biggan.attention``
(:mod:`~warpedganspace_torch.utils.spans`): a trace puts the kernels each
launches down to it.

The projection discriminator and the G_D pair (BigGAN.py:247-445) belong to
the model family, though the WarpedGANSpace pipeline runs neither: D's
attention block is the generator's, so on a CUDA device it too goes through
the forward kernel, one launch per attention block and D forward.

Spectral normalization is folded into the weights when a checkpoint is
converted (:mod:`warpedganspace_torch.convert.biggan`), so the module holds
plain dense weights only.

Class sampling: when ``y`` is not given, a class per batch element is drawn
from ``target_classes`` by an integer hash of the bits of ``z[:, 0]`` and the
row index, computed on z's device (:func:`class_draw`). The same z gives the
same classes, a (code, shifted code) pair built from one z is consistent, as
in the JAX package, and the draw reads nothing back to the host, so it runs
inside a CUDA graph and is bit for bit the same on the card and the CPU. With
one target class (every script of the reference) both packages agree exactly;
with several, the draws differ from the JAX package's, whose ``jax.random``
stream the hash does not reproduce.
"""
from __future__ import annotations

import json
import os.path as osp

import torch
import torch.nn.functional as F
from torch import nn

from warpedganspace_torch.ops.attn_cuda import sa_attention
from warpedganspace_torch.utils.spans import span

# Dataset registries (reference models/BigGAN/utils.py:7-32).
IMSIZE_DICT = {"I32": 32, "I32_hdf5": 32, "I64": 64, "I64_hdf5": 64,
               "I128": 128, "I128_hdf5": 128, "I256": 256, "I256_hdf5": 256,
               "C10": 32, "C100": 32}
NCLASS_DICT = {"I32": 1000, "I32_hdf5": 1000, "I64": 1000, "I64_hdf5": 1000,
               "I128": 1000, "I128_hdf5": 1000, "I256": 1000, "I256_hdf5": 1000,
               "C10": 10, "C100": 100}

CONFIG_FILE = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "configs", "biggan_generator_config.json")


_MASK31 = 0x7FFFFFFF


def _mix31(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 31-bit integers in int64 arithmetic: xor-shift, multiply
    by an odd constant and keep the low 31 bits, twice. Every product stays
    below 2**58, so no step overflows and every device computes the same bits."""
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x045D9F3B) & _MASK31
    return x ^ (x >> 16)


def class_draw(z: torch.Tensor, n: int) -> torch.Tensor:
    """Index in ``[0, n)`` for each row of z, on z's device: the salt is the
    int64 sum of ``z[:, 0]`` read as int32 bits, and row i draws
    ``mix(mix(salt) ^ i) mod n``."""
    bits = z[:, 0].detach().float().contiguous().view(torch.int32)
    salt = bits.sum(dtype=torch.int64).abs() & _MASK31
    rows = torch.arange(z.shape[0], device=z.device, dtype=torch.int64)
    return _mix31(_mix31(salt) ^ rows) % n


def biggan_arch(ch: int = 96, resolution: int = 128, attention: str = "64") -> dict:
    """Generator architecture table, all reference resolutions
    (reference BigGAN.py:13-52). ``attention`` is the reference's G_attn
    spec: underscore-separated resolutions, e.g. "32_64"."""
    tables = {
        512: {
            "in_channels": [ch * m for m in [16, 16, 8, 8, 4, 2, 1]],
            "out_channels": [ch * m for m in [16, 8, 8, 4, 2, 1, 1]],
            "resolution": [8, 16, 32, 64, 128, 256, 512],
        },
        256: {
            "in_channels": [ch * m for m in [16, 16, 8, 8, 4, 2]],
            "out_channels": [ch * m for m in [16, 8, 8, 4, 2, 1]],
            "resolution": [8, 16, 32, 64, 128, 256],
        },
        128: {
            "in_channels": [ch * m for m in [16, 16, 8, 4, 2]],
            "out_channels": [ch * m for m in [16, 8, 4, 2, 1]],
            "resolution": [8, 16, 32, 64, 128],
        },
        64: {
            "in_channels": [ch * m for m in [16, 16, 8, 4]],
            "out_channels": [ch * m for m in [16, 8, 4, 2]],
            "resolution": [8, 16, 32, 64],
        },
        32: {
            "in_channels": [ch * m for m in [4, 4, 4]],
            "out_channels": [ch * m for m in [4, 4, 4]],
            "resolution": [8, 16, 32],
        },
    }
    arch = tables[resolution]
    attn_res = {int(a) for a in str(attention).split("_")}
    arch["attention"] = [r in attn_res for r in arch["resolution"]]
    return arch


def _normal(shape, generator, std: float = 0.02):
    return std * torch.randn(shape, generator=generator, dtype=torch.float32)


def _conv(in_ch: int, out_ch: int, kernel: int, generator, bias: bool = True) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(_normal(conv.weight.shape, generator))
        if bias:
            conv.bias.zero_()
    return conv


def _linear(in_dim: int, out_dim: int, generator, bias: bool = True) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(_normal(lin.weight.shape, generator))
        if bias:
            lin.bias.zero_()
    return lin


class CCBN(nn.Module):
    """Class-conditional BN, eval mode (layers.py:303-322)."""

    def __init__(self, channels: int, cond_dim: int, generator, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gain = _linear(cond_dim, channels, generator, bias=False)
        self.bias = _linear(cond_dim, channels, generator, bias=False)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, cond):
        with span("wgs.biggan.ccbn"):
            mean, var = self.mean[None, :, None, None], self.var[None, :, None, None]
            xhat = (x - mean) * torch.rsqrt(var + self.eps)
            gain = 1.0 + self.gain(cond)                   # (B, C)
            bias = self.bias(cond)
            return xhat * gain[:, :, None, None] + bias[:, :, None, None]


class OutputBN(nn.Module):
    """Affine batch-norm with stored statistics (the output layer's BN)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        a = torch.rsqrt(self.var + self.eps) * self.scale
        b = self.bias - self.mean * a
        return x * a[None, :, None, None] + b[None, :, None, None]


class Attention(nn.Module):
    """SA-GAN non-local block (layers.py:141-166). x: (B, C, H, W)."""

    def __init__(self, channels: int, generator):
        super().__init__()
        self.theta = _conv(channels, channels // 8, 1, generator, bias=False)
        self.phi = _conv(channels, channels // 8, 1, generator, bias=False)
        self.g = _conv(channels, channels // 2, 1, generator, bias=False)
        self.o = _conv(channels // 2, channels, 1, generator, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        with span("wgs.biggan.attention"):
            b, c, h, w = x.shape
            # (B, C', H, W) -> (B, H*W, C'): queries and pooled keys in row-major
            # order of their maps, the layout of the JAX package's attention.
            theta = self.theta(x).flatten(2).transpose(1, 2).contiguous()
            phi = F.max_pool2d(self.phi(x), 2).flatten(2).transpose(1, 2).contiguous()
            g = F.max_pool2d(self.g(x), 2).flatten(2).transpose(1, 2).contiguous()
            o = sa_attention(theta, phi, g)                # (B, H*W, C/2)
            o = o.transpose(1, 2).reshape(b, c // 2, h, w)
            return self.gamma * self.o(o) + x


class GBlock(nn.Module):
    """Generator residual block (layers.py:372-405); always upsamples here."""

    def __init__(self, in_ch: int, out_ch: int, cond_dim: int, attention: bool, generator):
        super().__init__()
        self.bn1 = CCBN(in_ch, cond_dim, generator)
        self.conv1 = _conv(in_ch, out_ch, 3, generator)
        self.bn2 = CCBN(out_ch, cond_dim, generator)
        self.conv2 = _conv(out_ch, out_ch, 3, generator)
        self.conv_sc = _conv(in_ch, out_ch, 1, generator)
        self.attention = Attention(out_ch, generator) if attention else None

    def forward(self, x, cond):
        h = F.relu(self.bn1(x, cond))
        h = self.conv1(F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.conv2(F.relu(self.bn2(h, cond)))
        x = self.conv_sc(F.interpolate(x, scale_factor=2, mode="nearest"))
        h = h + x
        return h if self.attention is None else self.attention(h)


class BigGANGenerator(nn.Module):
    """The frozen BigGAN generator; images are NCHW in tanh range.

    Random initial weights are N(0, 0.02) from ``generator`` (zero biases and
    attention gamma, unit BN scale), as the JAX package's ``init``.
    """

    def __init__(self, resolution: int = 128, ch: int = 96, dim_z: int = 120,
                 shared_dim: int = 128, n_classes: int = 1000, bottom_width: int = 4,
                 target_classes=(239,), attention: str = "64",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.resolution = resolution
        self.ch = ch
        self.dim_z = dim_z
        self.shared_dim = shared_dim
        self.n_classes = n_classes
        self.bottom_width = bottom_width
        self.target_classes = target_classes
        self.attention = str(attention)
        arch = self.arch
        cond_dim = shared_dim + self.z_chunk_size
        self.shared_embed = nn.Parameter(_normal((n_classes, shared_dim), generator))
        self.linear = _linear(self.z_chunk_size, arch["in_channels"][0] * bottom_width ** 2,
                              generator)
        self.blocks = nn.ModuleList(
            GBlock(cin, cout, cond_dim, attn, generator)
            for cin, cout, attn in zip(arch["in_channels"], arch["out_channels"],
                                       arch["attention"]))
        self.out_bn = OutputBN(arch["out_channels"][-1])
        self.out_conv = _conv(arch["out_channels"][-1], 3, 3, generator)

    @classmethod
    def from_config(cls, config: dict | None = None, target_classes=(239,),
                    generator: torch.Generator | None = None) -> "BigGANGenerator":
        """Build from a BigGAN generator_config.json dict (reference
        models/gan_load.py:84-98 reads the shipped config; the port's copy is
        configs/biggan_generator_config.json). imsize/nclass per dataset follow
        reference models/BigGAN/utils.py."""
        if config is None:
            with open(CONFIG_FILE) as f:
                config = json.load(f)
        return cls(resolution=IMSIZE_DICT[config["dataset"]], ch=config["G_ch"],
                   dim_z=config["dim_z"], shared_dim=config["shared_dim"],
                   n_classes=NCLASS_DICT[config["dataset"]], target_classes=target_classes,
                   attention=str(config.get("G_attn", "64")), generator=generator)

    @property
    def target_classes(self) -> tuple:
        return self._target_classes

    @target_classes.setter
    def target_classes(self, target_classes) -> None:
        # Also as a buffer on the generator's device, so that a forward copies
        # nothing from the host (a CUDA graph of the training step captures it).
        self._target_classes = tuple(int(c) for c in target_classes)
        device = self.classes.device if "classes" in self._buffers else None
        self.register_buffer("classes", torch.tensor(self._target_classes, dtype=torch.long,
                                                     device=device), persistent=False)

    @property
    def arch(self) -> dict:
        return biggan_arch(self.ch, self.resolution, self.attention)

    @property
    def num_slots(self) -> int:
        return len(self.arch["in_channels"]) + 1

    @property
    def z_chunk_size(self) -> int:
        return self.dim_z // self.num_slots

    @property
    def dim_z_effective(self) -> int:
        """The reference SHRINKS dim_z to z_chunk_size * num_slots when the
        hierarchical split is not exact (BigGAN.py:102-111), e.g. 120 -> 119
        at 256^2 (7 slots). ``apply`` accepts z of either length (trailing
        elements are unused, exactly like the reference's narrow())."""
        return self.z_chunk_size * self.num_slots

    def mixed_classes(self, z: torch.Tensor, y=None) -> torch.Tensor:
        """Per-sample target class (see the module docstring for how the draws
        relate to the JAX package's)."""
        if y is not None:
            return y
        classes = self.classes
        if len(self.target_classes) == 1:
            return classes.expand(z.shape[0])
        return classes[class_draw(z, len(self.target_classes))]

    def apply(self, z, shift=None, y=None, latent_is_w: bool = False):
        """G(z + shift, shared(y)) -> (B, 3, H, W) in tanh range
        (BigGANWrapper.forward, gan_load.py:79-81; Generator.forward,
        BigGAN.py:222-243). BigGAN has no W space: ``latent_is_w`` is part of
        the uniform contract and is ignored."""
        y = self.mixed_classes(z, y)
        if shift is not None:
            z = z + shift
        y_embed = self.shared_embed[y]                     # (B, shared_dim)
        size = self.z_chunk_size
        chunks = [z[:, i * size:(i + 1) * size] for i in range(self.num_slots)]
        h = self.linear(chunks[0])
        h = h.view(z.shape[0], -1, self.bottom_width, self.bottom_width)
        for block, zc in zip(self.blocks, chunks[1:]):
            h = block(h, torch.cat([y_embed, zc], dim=1))
        h = self.out_conv(F.relu(self.out_bn(h)))
        return torch.tanh(h)

    forward = apply


def biggan_d_arch(ch: int = 96, resolution: int = 128, attention: str = "64") -> dict:
    """Discriminator architecture tables, all reference resolutions
    (reference BigGAN.py:247-279). ``attention`` is the D_attn spec."""
    tables = {
        256: {
            "in_channels": [3] + [ch * m for m in [1, 2, 4, 8, 8, 16]],
            "out_channels": [ch * m for m in [1, 2, 4, 8, 8, 16, 16]],
            "downsample": [True] * 6 + [False],
            "resolution": [128, 64, 32, 16, 8, 4, 4],
        },
        128: {
            "in_channels": [3] + [ch * m for m in [1, 2, 4, 8, 16]],
            "out_channels": [ch * m for m in [1, 2, 4, 8, 16, 16]],
            "downsample": [True] * 5 + [False],
            "resolution": [64, 32, 16, 8, 4, 4],
        },
        64: {
            "in_channels": [3] + [ch * m for m in [1, 2, 4, 8]],
            "out_channels": [ch * m for m in [1, 2, 4, 8, 16]],
            "downsample": [True] * 4 + [False],
            "resolution": [32, 16, 8, 4, 4],
        },
        32: {
            "in_channels": [3] + [ch * m for m in [4, 4, 4]],
            "out_channels": [ch * m for m in [4, 4, 4, 4]],
            "downsample": [True, True, False, False],
            "resolution": [16, 16, 16, 16],
        },
    }
    arch = tables[resolution]
    attn_res = {int(a) for a in str(attention).split("_")}
    arch["attention"] = [r in attn_res for r in arch["resolution"]]
    return arch


class DBlock(nn.Module):
    """Discriminator residual block (layers.py:408-455), wide. Every block but
    the first is preactivated; the learnable shortcut then convolves before it
    pools, and without preactivation pools before it convolves."""

    def __init__(self, in_ch: int, out_ch: int, preactivation: bool, downsample: bool,
                 attention: bool, generator):
        super().__init__()
        self.preactivation = preactivation
        self.downsample = downsample
        self.conv1 = _conv(in_ch, out_ch, 3, generator)
        self.conv2 = _conv(out_ch, out_ch, 3, generator)
        self.conv_sc = (_conv(in_ch, out_ch, 1, generator)
                        if in_ch != out_ch or downsample else None)
        self.attention = Attention(out_ch, generator) if attention else None

    def forward(self, x):
        h = F.relu(x) if self.preactivation else x
        h = self.conv2(F.relu(self.conv1(h)))
        if self.downsample:
            h = F.avg_pool2d(h, 2)
        sc = x
        if self.conv_sc is not None and self.preactivation:
            sc = self.conv_sc(sc)
        if self.downsample:
            sc = F.avg_pool2d(sc, 2)
        if self.conv_sc is not None and not self.preactivation:
            sc = self.conv_sc(sc)
        h = h + sc
        return h if self.attention is None else self.attention(h)


class BigGANDiscriminator(nn.Module):
    """The projection discriminator: (B, 3, H, W) images and (B,) class ids ->
    (B, 1) logits (reference BigGAN.py:281-399). After the blocks, a ReLU and a
    global sum pool give h (B, C); the logit is linear(h) + sum(embed[y] * h).

    Random initial weights are N(0, 0.02) from ``generator`` (zero biases and
    attention gamma), as the JAX package's ``init``; checkpoints are loaded
    through :mod:`warpedganspace_torch.convert.biggan`, which folds the
    spectral norm."""

    def __init__(self, resolution: int = 128, ch: int = 96, n_classes: int = 1000,
                 attention: str = "64", generator: torch.Generator | None = None):
        super().__init__()
        self.resolution = resolution
        self.ch = ch
        self.n_classes = n_classes
        self.attention = str(attention)
        arch = biggan_d_arch(ch, resolution, self.attention)
        self.blocks = nn.ModuleList(
            DBlock(cin, cout, i > 0, down, attn, generator)
            for i, (cin, cout, down, attn) in enumerate(zip(
                arch["in_channels"], arch["out_channels"], arch["downsample"],
                arch["attention"])))
        c = arch["out_channels"][-1]
        self.linear = _linear(c, 1, generator)
        self.embed = nn.Embedding(n_classes, c)
        with torch.no_grad():
            self.embed.weight.copy_(_normal(self.embed.weight.shape, generator))

    def forward(self, x, y):
        h = x
        for block in self.blocks:
            h = block(h)
        h = torch.sum(F.relu(h), dim=(2, 3))               # (B, C)
        return self.linear(h) + torch.sum(self.embed(y) * h, dim=1, keepdim=True)


class BigGAN_GD(nn.Module):
    """G then D (reference G_D, BigGAN.py:404-445): scores a fake batch, and
    with real images ``x`` (classes ``dy``) the real batch too, as one D
    forward over the concatenation or, with ``split_D``, one forward each."""

    def __init__(self, G: BigGANGenerator, D: BigGANDiscriminator):
        super().__init__()
        self.G = G
        self.D = D

    def forward(self, z, gy, x=None, dy=None, split_D: bool = False):
        g_z = self.G.apply(z, y=gy)
        if split_D:
            d_fake = self.D(g_z, gy)
            return d_fake if x is None else (d_fake, self.D(x, dy))
        if x is None:
            return self.D(g_z, gy)
        d_out = self.D(torch.cat([g_z, x], dim=0), torch.cat([gy, dy], dim=0))
        return d_out[:z.shape[0]], d_out[z.shape[0]:]
