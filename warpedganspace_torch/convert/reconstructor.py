"""Reconstructor checkpoints in the reference ``.pt`` layout, both variants.

Counterpart of the reconstructor half of
:mod:`warpedganspace_tpu.convert.torch_import`. The port's
:class:`~warpedganspace_torch.models.reconstructor.Reconstructor` names its
parameters and buffers as the reference does (``lib/reconstructor.py``), so a
checkpoint is its ``state_dict()``; what is left to do here is to take numpy
arrays or tensors, to pass over what the reference's files carry and the model
never reads (torchvision's unused ``fc`` head), and to tolerate a missing
``num_batches_tracked``.
"""
from __future__ import annotations

import numpy as np
import torch

from warpedganspace_torch.models.reconstructor import Reconstructor

_UNUSED_PREFIXES = ("features_extractor.fc.",)


def load_reference_state_dict(R: Reconstructor, state_dict: dict) -> Reconstructor:
    """Load a reference-layout state dict (tensors or numpy arrays) into ``R`` in place."""
    own = R.state_dict()
    given = {k: v for k, v in state_dict.items() if not k.startswith(_UNUSED_PREFIXES)}
    unknown = sorted(set(given) - set(own))
    missing = sorted(k for k in set(own) - set(given) if not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(f"reconstructor state dict does not fit a {R.reconstructor_type} "
                       f"reconstructor: unknown keys {unknown}, missing keys {missing}")
    with torch.no_grad():
        for name, value in given.items():
            src = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
            dst = own[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return R


def to_reference_state_dict(R: Reconstructor) -> dict[str, torch.Tensor]:
    """``R``'s parameters and buffers under the reference's names, as CPU tensors."""
    return {k: v.detach().cpu().clone() for k, v in R.state_dict().items()}
