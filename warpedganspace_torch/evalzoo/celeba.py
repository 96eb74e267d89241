"""The CelebA 5-attribute predictor (Talk-to-Edit): a ResNet-50 trunk, an fc
stem and one classifier head per attribute.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.celeba` (reference
lib/evaluation/celeba_attributes/celeba_attr_predictor.py:88-191). The heads
come from the attribute file (``configs/attributes_5.json``) and are named
``classifier<index, 2 digits><name>`` as in the checkpoint; the caller scores
each as (argmax + max softmax) / 6 (traverse_attribute_space.py:367-371). The
reference loader first fetches ImageNet weights and then overwrites all of
them from the checkpoint; the port loads the checkpoint alone.
"""
from __future__ import annotations

import json

import torch
import torch.nn.functional as F
from torch import nn

from warpedganspace_torch.evalzoo.backbones import ResNetTrunk


class FCBlock(nn.Module):
    """Linear -> BatchNorm1d -> ReLU (the reference's dropout is identity at eval)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.fc = nn.Linear(inplanes, planes)
        self.bn = nn.BatchNorm1d(planes)

    def forward(self, x):
        return F.relu(self.bn(self.fc(x)))


class CelebaAttrPredictor(ResNetTrunk):
    """(B, 3, 224, 224) ImageNet-normalised batch -> {attribute: (B, 6) logits}."""

    def __init__(self, attr_info: dict):
        super().__init__(50)
        self.stem = FCBlock(self.num_features, 512)
        self.head_names = {}
        for key, val in attr_info.items():
            name = "classifier" + str(key).zfill(2) + val["name"]
            setattr(self, name, nn.Sequential(FCBlock(512, 256), nn.Linear(256, len(val["value"]))))
            self.head_names[val["name"]] = name

    @classmethod
    def from_state_dict(cls, sd: dict, attr_file: str) -> "CelebaAttrPredictor":
        with open(attr_file) as f:
            net = cls(json.load(f)["attr_info"])
        net.load_state_dict(sd, strict=True)
        return net.eval()

    def forward(self, x: torch.Tensor) -> dict:
        feats = self.stem(self.features(x))
        return {attr: getattr(self, name)(feats) for attr, name in self.head_names.items()}


def celeba_attr_predictor(attr_file: str, state_dict: dict) -> CelebaAttrPredictor:
    """The predictor from a checkpoint's state dict (the reference loads
    'state_dict' from eval_predictor.pth.tar, :189-191)."""
    return CelebaAttrPredictor.from_state_dict(state_dict, attr_file)
