"""Fused bias + leaky ReLU + gain, in plain PyTorch.

Counterpart of :mod:`warpedganspace_tpu.ops.fused_act` (reference
``op/fused_act.py``): ``scale * leaky_relu(x + bias)``, applied after every
StyleGAN2 conv and mapping layer with scale sqrt(2) and slope 0.2.
"""
from __future__ import annotations

import math

import torch


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """sqrt(2) * leaky_relu(x + bias, 0.2), bias broadcast along axis 1."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return math.sqrt(2.0) * torch.where(x >= 0, x, 0.2 * x)
