"""ResNet trunks in the torchvision layout, shared by three predictors.

Counterpart of :mod:`warpedganspace_tpu.evalzoo.backbones`: BasicBlock
(ResNet-34, FairFace) and Bottleneck (ResNet-50, Hopenet and the CelebA
predictor; reference lib/evaluation/hopenet/hopenet.py:5-66,
celeba_attributes/celeba_attr_predictor.py:106-191). The parameter names are
torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1`` ... ``downsample.0``),
which is the layout of the reference checkpoints. BatchNorm runs in eval mode
on its stored statistics; the stride sits on the 3x3 convolution of a
bottleneck, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

RESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResNetTrunk(nn.Module):
    """conv1/bn1/max-pool and layer1..4 of a torchvision ResNet; subclasses add
    their heads. ``features`` is the trunk and a global average pool."""

    def __init__(self, depth: int):
        super().__init__()
        block = Bottleneck if depth >= 50 else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), RESNET_LAYERS[depth]), 1):
            stride = 1 if li == 1 else 2
            downsample = None
            if stride != 1 or inplanes != planes * block.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(inplanes, planes * block.expansion, 1, stride, bias=False),
                    nn.BatchNorm2d(planes * block.expansion))
            layers = [block(inplanes, planes, stride, downsample)]
            inplanes = planes * block.expansion
            layers += [block(inplanes, planes) for _ in range(1, n)]
            setattr(self, f"layer{li}", nn.Sequential(*layers))
        self.num_features = inplanes

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, C, H/32, W/32). The max-pool pads with -inf, as
        the JAX package's reduce_window does."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(y))))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x).mean(dim=(2, 3))
