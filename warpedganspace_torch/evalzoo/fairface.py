"""FairFace: a torchvision ResNet-34 with an 18-way fc head.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.fairface` (reference
traverse_attribute_space.py:179-184: stock resnet34, fc rebuilt to 18
outputs). The caller slices race [0:7], gender [7:9] and age [9:18]
(:437-467).
"""
from __future__ import annotations

import torch
from torch import nn

from warpedganspace_torch.evalzoo.backbones import ResNetTrunk


class FairFace(ResNetTrunk):
    """(B, 3, 224, 224) ImageNet-normalised batch -> (B, 18) logits."""

    def __init__(self):
        super().__init__(34)
        self.fc = nn.Linear(self.num_features, 18)

    @classmethod
    def from_state_dict(cls, sd: dict) -> "FairFace":
        net = cls()
        net.load_state_dict(sd, strict=True)
        return net.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))
