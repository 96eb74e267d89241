"""Latent-code sampling with explicit ``torch.Generator``s.

Counterpart of :func:`warpedganspace_tpu.core.sampling.sample_z` (reference
lib/aux.py:39-53). The training samplers come with the training slice.
"""
from __future__ import annotations

import math

import torch


def sample_z(generator: torch.Generator, batch_size: int, dim_z: int,
             truncation: float | None = None, device=None) -> torch.Tensor:
    """z ~ N(0, I), or truncated to [-truncation, truncation], as float32.

    The draw happens on ``generator``'s device and the result is moved to
    ``device``, so a CPU generator gives the same codes for every device.
    """
    gen_device = generator.device
    if truncation is None or truncation == 1.0:
        z = torch.randn((batch_size, dim_z), generator=generator, device=gen_device)
    else:
        # Inverse CDF on [Phi(-t), Phi(t)]: Phi^-1(u) = sqrt(2) erfinv(2u - 1).
        lo = 0.5 * (1.0 + math.erf(-truncation / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(truncation / math.sqrt(2.0)))
        u = lo + (hi - lo) * torch.rand((batch_size, dim_z), generator=generator,
                                        dtype=torch.float64, device=gen_device)
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-truncation, truncation)
        z = z.float()
    return z.to(device)
