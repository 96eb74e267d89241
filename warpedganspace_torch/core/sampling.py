"""Latent-code and training-directive sampling with explicit ``torch.Generator``s.

Counterpart of :mod:`warpedganspace_tpu.core.sampling` (reference
lib/aux.py:39-53, lib/trainer.py:203-221). Every draw comes from a generator
the caller hands in, on that generator's device; :func:`reseed` makes the
training stream a pure function of (seed, iteration), so a resumed run draws
what the unbroken run drew. The numbers differ from the JAX package's for the
same seed (another generator); the distributions are the same.
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


def reseed(generator: torch.Generator, seed: int, iteration: int) -> torch.Generator:
    """Set ``generator`` to the state that belongs to (seed, iteration)."""
    generator.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(iteration)) % (1 << 63))
    return generator


def sample_shift_magnitudes(generator: torch.Generator, batch_size: int, min_mag: float,
                            max_mag: float) -> torch.Tensor:
    """Signed shift magnitudes, drawn the way the reference trainer draws them.

    Reference (lib/trainer.py:203-221): a pool of 2B magnitudes, B from
    U[-max, -min] followed by B from U[min, max], of which B are picked without
    replacement with probability proportional to the pool index
    (``torch.multinomial(arange(2B), B, replacement=False)``). That weighting
    is the reference's own quirk: index 0 is never picked and the later,
    positive entries are favoured.
    """
    dev = generator.device
    span = min_mag - max_mag  # negative, as in the reference expression
    pos = span * torch.rand(batch_size, generator=generator, device=dev) + max_mag   # U[min, max]
    neg = span * torch.rand(batch_size, generator=generator, device=dev) - min_mag   # U[-max, -min]
    pool = torch.cat([neg, pos])                                                     # (2B,)
    weights = torch.arange(2 * batch_size, dtype=torch.float32, device=dev)
    picked = torch.multinomial(weights, batch_size, replacement=False, generator=generator)
    return pool[picked]


def sample_batch_directives(generator: torch.Generator, batch_size: int, dim_z: int,
                            num_support_sets: int, min_shift_magnitude: float,
                            max_shift_magnitude: float, z_truncation: float | None = None):
    """One training batch's random inputs, on the generator's device.

    Returns (z, set_idx, magnitudes): z (B, dim_z) latent codes, set_idx (B,)
    int64 target support-set indices ~ U{0..K-1} (reference lib/trainer.py:203)
    and magnitudes (B,) signed shift magnitudes (:206-221).
    """
    dev = generator.device
    z = sample_z(generator, batch_size, dim_z, z_truncation, device=dev)
    set_idx = torch.randint(num_support_sets, (batch_size,), generator=generator, device=dev)
    mags = sample_shift_magnitudes(generator, batch_size, min_shift_magnitude,
                                   max_shift_magnitude)
    return z, set_idx, mags
