"""Torch-compatible ``.pt`` tensor IO with numpy on the caller's side.

Counterpart of :mod:`warpedganspace_tpu.utils.io`. The pipeline's on-disk
artifacts (latent_code.pt pools, support_sets.pt, paths_latent_codes.pt) are
``torch.save`` files shared with the reference and the JAX package; callers
hand over and get back numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def save_pt(obj, path: str) -> None:
    """torch.save ``obj`` with numpy arrays converted to torch tensors.

    Nested dicts/lists/tuples are converted recursively, so reference-style
    state dicts ({name: array}) round-trip as {name: torch.Tensor}.
    """
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x, copy=True))
        return x

    torch.save(conv(obj), path)


def load_pt(path: str):
    """torch.load a .pt file and convert tensors to numpy arrays recursively."""
    obj = torch.load(path, map_location="cpu", weights_only=False)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return conv(obj)
