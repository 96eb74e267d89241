"""Reconstructor R: predicts (path index, shift magnitude) from an image pair.

Counterpart of :mod:`warpedganspace_tpu.models.reconstructor` (reference
``lib/reconstructor.py``):

- ``LeNet`` (:18-49): width-2 LeNet over the channel-concatenated pair,
  3 x [conv5x5 -> BN -> ReLU (-> maxpool2)], spatial mean, and two
  linear -> BN -> ReLU -> linear heads (K path logits; one magnitude). Used
  for the 32 and 64 px GANs.
- ``ResNet`` (:52-69): torchvision's ResNet-18 with ``conv1`` rebuilt for 6
  input channels, features at the global average pool, and two linear heads.

Images are NCHW. Parameter and buffer names are the reference's state-dict
layout (``feature_extractor.N`` / ``features_extractor.layerL.B...``,
``path_indices``, ``shift_magnitudes``), so ``state_dict()`` is the file
format of ``reconstructor.pt``.

Mixed precision (``dtype=torch.bfloat16``) is written out, not autocast:
convolution weights are cast at use while the float32 parameters stay the
masters, BatchNorm takes its moments, keeps its running statistics (momentum
0.1, unbiased variance into the running value, eps 1e-5) and forms its affine
in float32 and applies it as one ``x * A + B`` in x's type, and the global
pool and both heads run in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_RESNET18_LAYERS = ((64, 1), (128, 2), (256, 2), (512, 2))  # (channels, first stride)


class BatchNorm(nn.Module):
    """BatchNorm over all axes but the channel axis 1, torch semantics, with
    the float32 statistics policy of the module docstring. Names follow
    ``nn.BatchNorm2d`` (weight, bias, running_mean, running_var,
    num_batches_tracked)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        low_precision = x.dtype != torch.float32
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean        # biased, for the normalization
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var * (n / max(n - 1, 1)))
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if low_precision:
            a = inv * self.weight
            b = self.bias - mean * a
            return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        return (x - mean.view(shape)) * inv.view(shape) * self.weight.view(shape) \
            + self.bias.view(shape)


def _conv(conv: nn.Conv2d, x):
    """The convolution with its weight (and bias) cast to x's type at use."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


def _kaiming_normal_(w: torch.Tensor, generator) -> None:
    """torch ``kaiming_normal_(mode='fan_out', nonlinearity='relu')`` for OIHW."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.copy_(math.sqrt(2.0 / fan_out) * torch.randn(w.shape, generator=generator))


def _default_init_(layer, generator) -> None:
    """torch's default Conv2d / Linear init: U(+-1/sqrt(fan_in)) for both."""
    w = layer.weight
    bound = 1.0 / math.sqrt(w[0].numel())
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)
        if layer.bias is not None:
            layer.bias.copy_((torch.rand(layer.bias.shape, generator=generator) * 2 - 1) * bound)


class BasicBlock(nn.Module):
    """torchvision ResNet BasicBlock; ``downsample`` is Sequential(conv1x1, BN)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, generator):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False),
                                            BatchNorm(out_ch))
        for conv in (self.conv1, self.conv2) + (() if self.downsample is None
                                                 else (self.downsample[0],)):
            _kaiming_normal_(conv.weight, generator)

    def forward(self, x):
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = self.bn2(_conv(self.conv2, y))
        if self.downsample is not None:
            x = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + x)


class _ResNet18Features(nn.Module):
    """ResNet-18 up to the global average pool, with a ``2 * channels``-input conv1."""

    def __init__(self, in_ch: int, generator):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        _kaiming_normal_(self.conv1.weight, generator)
        self.bn1 = BatchNorm(64)
        ch = 64
        for li, (out_ch, stride) in enumerate(_RESNET18_LAYERS, start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(ch, out_ch, stride, generator), BasicBlock(out_ch, out_ch, 1, generator)))
            ch = out_ch

    def forward(self, x):
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.max_pool2d(y, 3, 2, 1)
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
        return y.float().mean((2, 3))                       # (B, 512), float32


class _Head(nn.Sequential):
    """LeNet head: linear -> BN -> ReLU -> linear (indices 0, 1, 3 of the Sequential)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, generator):
        super().__init__(nn.Linear(in_dim, hidden), BatchNorm(hidden), nn.ReLU(),
                         nn.Linear(hidden, out_dim))
        _default_init_(self[0], generator)
        _default_init_(self[3], generator)


class Reconstructor(nn.Module):
    """``R(x1, x2) -> (logits (B, K), magnitudes (B,))``, both float32.

    ``reconstructor_type`` is 'LeNet' or 'ResNet', ``dim`` is K, ``channels``
    the image channels. ``dtype=torch.bfloat16`` runs the convolution trunk in
    bfloat16 (see the module docstring). Train mode uses batch statistics and
    refreshes the running ones in place.
    """

    def __init__(self, reconstructor_type: str, dim: int, channels: int = 3,
                 lenet_width: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.reconstructor_type = reconstructor_type
        self.dim = dim
        self.channels = channels
        if reconstructor_type == "LeNet":
            w = lenet_width
            convs = [nn.Conv2d(2 * channels, 3 * w, 5), nn.Conv2d(3 * w, 8 * w, 5),
                     nn.Conv2d(8 * w, 60 * w, 5)]
            for conv in convs:
                _default_init_(conv, generator)
            # Indices 0, 1, 4, 5, 8, 9 hold the parameters, as in the reference.
            self.feature_extractor = nn.Sequential(
                convs[0], BatchNorm(3 * w), nn.ReLU(), nn.MaxPool2d(2, 2),
                convs[1], BatchNorm(8 * w), nn.ReLU(), nn.MaxPool2d(2, 2),
                convs[2], BatchNorm(60 * w), nn.ReLU())
            self.path_indices = _Head(60 * w, 42 * w, dim, generator)
            self.shift_magnitudes = _Head(60 * w, 42 * w, 1, generator)
        elif reconstructor_type == "ResNet":
            self.features_extractor = _ResNet18Features(2 * channels, generator)
            self.path_indices = nn.Linear(512, dim)
            self.shift_magnitudes = nn.Linear(512, 1)
            _default_init_(self.path_indices, generator)
            _default_init_(self.shift_magnitudes, generator)
        else:
            raise ValueError(f"unknown reconstructor type {reconstructor_type!r}")

    def forward(self, x1, x2, dtype: torch.dtype | None = None):
        x = torch.cat([x1, x2], dim=1)
        if dtype is not None:
            x = x.to(dtype)
        if self.reconstructor_type == "LeNet":
            for layer in self.feature_extractor:
                x = _conv(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
            feats = x.float().mean((2, 3))                  # (B, 60w), float32
        else:
            feats = self.features_extractor(x)
        return self.path_indices(feats), self.shift_magnitudes(feats)[:, 0]
