"""ArcFace identity comparator: an SE-IR-50 backbone and cosine similarity.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.arcface` (reference
lib/evaluation/archface/arcface.py): the fixed face crop
``x[:, :, 35:223, 32:220]`` and an adaptive average pool to 112² (:16-19), the
SE-IR bottleneck stack (:82-130), the output BN-dropout-flatten-linear-BN1d and
an l2 norm (:141-147, :36-39), and the cosine similarity of two embeddings
(:14, :21-22). The module's parameter names are the bare checkpoint's
(``input_layer``, ``body.<i>.res_layer``, ``output_layer``), as
``model_ir_se50.pth`` stores them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def blocks_50():
    """(in_channel, depth, stride) of each bottleneck, 50-layer config (:114-121)."""
    spec = []
    for in_ch, depth, units in ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)):
        spec.append((in_ch, depth, 2))
        spec.extend((depth, depth, 1) for _ in range(units - 1))
    return spec


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    def __init__(self, in_channel: int, depth: int, stride: int):
        super().__init__()
        if in_channel == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)   # plain subsampling
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False), nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(in_channel),
            nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            nn.BatchNorm2d(depth),
            SEModule(depth, 16))

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


class SEIR50(nn.Module):
    """(B, 3, 112, 112) -> l2-normalised 512-d embeddings."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(nn.Conv2d(3, 64, 3, 1, 1, bias=False),
                                         nn.BatchNorm2d(64), nn.PReLU(64))
        self.body = nn.Sequential(*(BottleneckIRSE(*spec) for spec in blocks_50()))
        self.output_layer = nn.Sequential(nn.BatchNorm2d(512), nn.Dropout(0.4), nn.Flatten(),
                                          nn.Linear(512 * 7 * 7, 512), nn.BatchNorm1d(512))

    def forward(self, x):
        y = self.output_layer(self.body(self.input_layer(x)))
        return y / torch.linalg.vector_norm(y, dim=1, keepdim=True)


class IDComparator:
    """Cosine identity similarity of image pairs (reference :8-22) on (B, 3,
    256, 256) batches in [-1, 1], as the attribute stage gives them."""

    def __init__(self, net: SEIR50):
        self.net = net.eval()

    @classmethod
    def from_state_dict(cls, sd: dict, prefix: str = "backbone.") -> "IDComparator":
        """``prefix``: the keys' prefix in ``sd`` (the raw checkpoint has none;
        the JAX package's loader passes ``""`` too)."""
        net = SEIR50()
        net.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                            strict=True)
        return cls(net)

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        x = F.adaptive_avg_pool2d(x[:, :, 35:223, 32:220], (112, 112))
        return self.net(x)

    @torch.no_grad()
    def similarities(self, x: torch.Tensor, x_prime: torch.Tensor) -> torch.Tensor:
        """Per-pair cosine similarities: the batched form of the reference's one
        pair a forward (traverse_attribute_space.py:395-415)."""
        e1, e2 = self.extract(x), self.extract(x_prime)
        return (e1 * e2).sum(dim=1) / (torch.linalg.vector_norm(e1, dim=1)
                                       * torch.linalg.vector_norm(e2, dim=1) + 1e-6)

    def __call__(self, x, x_prime):
        return self.similarities(x, x_prime).mean()
