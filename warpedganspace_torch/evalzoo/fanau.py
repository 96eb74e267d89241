"""FAN-AU action units: a 68-point FAN (one hourglass module) feeding a
lightweight hourglass head that gives 12 AU heatmaps.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.fanau` (reference
lib/evaluation/au_detector/hourglass.py: ConvBlock with ReLU6 and a
channel-concatenating residual :17-66, the recursive HourGlass :69-113, QFAN
:116-180, FANAU :216-243; AU_detector.py: min-max input normalisation over the
whole batch :36, each intensity the global max of its 64x64 heatmap :43-46).
The module names (``fan.conv2.bn1``, ``net.b2_plus_1.conv3``, ...) are the
checkpoint's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """Three conv-BN-ReLU6 stages of out/2, out/4 and out/4 channels,
    concatenated, plus the input (through a 1x1 conv-BN-ReLU6 where the widths
    differ). ``lightweight`` makes all three convolutions 1x1."""

    def __init__(self, in_planes: int, out_planes: int, lightweight: bool = False):
        super().__init__()
        k, p = (1, 0) if lightweight else (3, 1)
        half, quarter = out_planes // 2, out_planes // 4
        self.conv1 = nn.Conv2d(in_planes, half, k, 1, p, bias=False)
        self.bn1 = nn.BatchNorm2d(half)
        self.conv2 = nn.Conv2d(half, quarter, k, 1, p, bias=False)
        self.bn2 = nn.BatchNorm2d(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, k, 1, p, bias=False)
        self.bn3 = nn.BatchNorm2d(quarter)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, out_planes, 1, bias=False),
                                            nn.BatchNorm2d(out_planes), nn.ReLU6())

    def forward(self, x):
        out1 = F.relu6(self.bn1(self.conv1(x)))
        out2 = F.relu6(self.bn2(self.conv2(out1)))
        out3 = F.relu6(self.bn3(self.conv3(out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + residual


class HourGlass(nn.Module):
    def __init__(self, depth: int, features: int, lightweight: bool = False):
        super().__init__()
        self.depth = depth
        for level in range(1, depth + 1):
            for b in ("b1", "b2", "b3"):
                setattr(self, f"{b}_{level}", ConvBlock(features, features, lightweight))
        self.b2_plus_1 = ConvBlock(features, features, lightweight)

    def _level(self, level: int, x):
        up1 = getattr(self, f"b1_{level}")(x)
        low1 = getattr(self, f"b2_{level}")(F.max_pool2d(x, 2, 2))
        low2 = self._level(level - 1, low1) if level > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{level}")(low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(self.depth, x)


class QFAN(nn.Module):
    """The 68-point FAN with one hourglass module: (heatmaps, features)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        self.m0 = HourGlass(4, 256)
        self.top_m_0 = ConvBlock(256, 256)
        self.conv_last0 = nn.Conv2d(256, 256, 1)
        self.bn_end0 = nn.BatchNorm2d(256)
        self.l0 = nn.Conv2d(256, 68, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(self.conv2(x), 2, 2)
        features = self.conv4(self.conv3(x))
        ll = self.top_m_0(self.m0(features))
        ll = F.relu(self.bn_end0(self.conv_last0(ll)))
        return self.l0(ll), features


def _seq(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout), nn.ReLU6())


class FANAU(nn.Module):
    """(B, 3, 256, 256) normalised input -> (B, 12, 64, 64) AU heatmaps."""

    def __init__(self, n_points: int = 12):
        super().__init__()
        self.fan = QFAN()
        self.conv1 = _seq(68, 128)
        self.conv2 = _seq(256, 128)
        self.net = HourGlass(4, 128, lightweight=True)
        self.conv_last = _seq(128, 128)
        self.l = nn.Conv2d(128, n_points, 1)

    def forward(self, x):
        heat, features = self.fan(x)
        h = self.net(self.conv1(heat) + self.conv2(features))
        return self.l(self.conv_last(h))


class AUdetector:
    """The reference's API (AU_detector.py:30-46) around a :class:`FANAU`."""

    def __init__(self, net: FANAU):
        self.net = net.eval()
        self.naus = 12

    @classmethod
    def from_state_dict(cls, sd: dict) -> "AUdetector":
        net = FANAU()
        net.load_state_dict(sd, strict=True)
        return cls(net)

    @torch.no_grad()
    def detect_AU(self, img: torch.Tensor) -> torch.Tensor:
        """(B, 3, 256, 256) raw images -> (B, 12) intensities: min-max over the
        WHOLE batch, each intensity the global max of its heatmap."""
        img = img.float()
        img = (img - img.min()) / (img.max() - img.min())
        if img.dim() == 3:
            img = img[None]
        return self.net(img).amax(dim=(2, 3))
