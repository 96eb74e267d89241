"""SNGAN torch checkpoint (the reference ``GenWrapper``) -> the port's generator state dict.

Counterpart of ``sngan_params_from_state_dict`` in
:mod:`warpedganspace_tpu.convert.torch_import` (reference
``models/SNGAN/sn_gen_resnet.py:86-112``). The reference generator is one
``Sequential`` under ``model``: [0] the dense layer, [1] the reshape,
[2 .. 2+B-1] the residual blocks, [2+B] BatchNorm, [2+B+1] ReLU, [2+B+2] the
output conv, [2+B+3] tanh. Inside a block, ``model.0`` is the first
BatchNorm, ``conv1`` and ``conv2`` the two convs, ``model.4`` the second
BatchNorm and ``bypass.1`` the bypass conv where the channels change. The
convolutions are OIHW and the linear (out, in), the port's own layouts, so
only the names change.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _copy(sd, src: str, dst: str, out: dict, names) -> None:
    for name in names:
        out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])


def _bn(sd, src: str, dst: str, out: dict) -> None:
    _copy(sd, src, dst, out, ("weight", "bias", "running_mean", "running_var"))


def sngan_state_dict_from_reference(sd: dict, channels) -> dict[str, torch.Tensor]:
    """Reference SNGAN ``GenWrapper`` ``state_dict`` (tensors or numpy arrays)
    -> the ``state_dict`` of :class:`warpedganspace_torch.models.sngan.SNGANGenerator`
    with the given channel chain."""
    n_blocks = len(channels) - 1
    out: dict[str, torch.Tensor] = {}
    _copy(sd, "model.0", "dense", out, ("weight", "bias"))
    for i in range(n_blocks):
        src, dst = f"model.{2 + i}", f"blocks.{i}"
        _bn(sd, src + ".model.0", dst + ".bn1", out)
        _copy(sd, src + ".conv1", dst + ".conv1", out, ("weight", "bias"))
        _bn(sd, src + ".model.4", dst + ".bn2", out)
        _copy(sd, src + ".conv2", dst + ".conv2", out, ("weight", "bias"))
        if channels[i] != channels[i + 1]:
            _copy(sd, src + ".bypass.1", dst + ".bypass", out, ("weight", "bias"))
    _bn(sd, f"model.{2 + n_blocks}", "out_bn", out)
    _copy(sd, f"model.{2 + n_blocks + 2}", "out_conv", out, ("weight", "bias"))
    return out


def load_reference_state_dict(gen, sd: dict):
    """Load a reference SNGAN ``state_dict`` into ``gen`` (strict)."""
    gen.load_state_dict(sngan_state_dict_from_reference(sd, gen.channels))
    return gen
