"""ProgGAN torch checkpoint (the reference ``.pth``) -> the port's generator state dict.

Counterpart of ``proggan_params_from_state_dict`` in
:mod:`warpedganspace_tpu.convert.torch_import` (reference
``models/ProgGAN/model.py:65-95``). Feature blocks live at ``features.N`` with
``{conv.weight, wscale.scale, wscale.b}``, the output head at
``output.{conv, wscale}``. The convolutions are OIHW, the port's own layout,
so only the names change.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _block(sd, src: str, dst: str, out: dict) -> None:
    out[dst + ".weight"] = _tensor(sd[src + ".conv.weight"])
    out[dst + ".scale"] = _tensor(sd[src + ".wscale.scale"]).reshape(1)
    out[dst + ".bias"] = _tensor(sd[src + ".wscale.b"]).reshape(-1)


def proggan_state_dict_from_reference(sd: dict) -> dict[str, torch.Tensor]:
    """Reference ProgGAN ``state_dict`` (tensors or numpy arrays) -> the
    ``state_dict`` of :class:`warpedganspace_torch.models.proggan.ProgGANGenerator`."""
    out: dict[str, torch.Tensor] = {}
    i = 0
    while f"features.{i}.conv.weight" in sd:
        _block(sd, f"features.{i}", f"blocks.{i}", out)
        i += 1
    _block(sd, "output", "out", out)
    return out


def load_reference_state_dict(gen, sd: dict):
    """Load a reference ProgGAN ``state_dict`` into ``gen`` (strict)."""
    gen.load_state_dict(proggan_state_dict_from_reference(sd))
    return gen
