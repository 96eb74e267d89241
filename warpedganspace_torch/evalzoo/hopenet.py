"""Hopenet head pose: a ResNet-50 trunk and three 66-bin heads.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.hopenet` (reference
lib/evaluation/hopenet/hopenet.py:5-66). The angles are the softmax
expectation of the bins x 3 - 99 degrees (traverse_attribute_space.py:488-493).
"""
from __future__ import annotations

import torch
from torch import nn

from warpedganspace_torch.evalzoo.backbones import ResNetTrunk


class Hopenet(ResNetTrunk):
    """(B, 3, 224, 224) ImageNet-normalised batch -> (yaw, pitch, roll) logits,
    each (B, 66)."""

    def __init__(self, num_bins: int = 66):
        super().__init__(50)
        self.fc_yaw = nn.Linear(self.num_features, num_bins)
        self.fc_pitch = nn.Linear(self.num_features, num_bins)
        self.fc_roll = nn.Linear(self.num_features, num_bins)
        # The reference's vestigial layer: in the checkpoint, never applied.
        self.fc_finetune = nn.Linear(self.num_features + 3, 3)

    @classmethod
    def from_state_dict(cls, sd: dict) -> "Hopenet":
        net = cls()
        net.load_state_dict(sd, strict=True)
        return net.eval()

    def forward(self, x: torch.Tensor):
        feats = self.features(x)
        return self.fc_yaw(feats), self.fc_pitch(feats), self.fc_roll(feats)

    @staticmethod
    def angles_deg(logits: torch.Tensor) -> torch.Tensor:
        """The softmax expectation of the 66 bins, in degrees."""
        probs = torch.softmax(logits, dim=-1)
        idx = torch.arange(logits.shape[-1], dtype=probs.dtype, device=probs.device)
        return (probs * idx).sum(dim=-1) * 3.0 - 99.0
