"""The port's training samplers (``core/sampling.py``): the reference's ranges,
signs and pool quirk, and a stream that is a function of (seed, iteration).

The numbers cannot equal the JAX package's (another generator), so what is
held is what ``tests/test_sampling.py`` holds the JAX samplers to.
"""
import numpy as np
import pytest
import torch

from warpedganspace_torch.core.sampling import (reseed, sample_batch_directives,
                                                sample_shift_magnitudes)

torch.set_num_threads(1)


def _gen(seed, iteration=0):
    return reseed(torch.Generator(), seed, iteration)


def test_magnitudes_ranges_and_signs():
    mags = sample_shift_magnitudes(_gen(0), 256, 0.1, 0.2).numpy()
    assert mags.shape == (256,) and mags.dtype == np.float32
    assert np.all((np.abs(mags) >= 0.1) & (np.abs(mags) <= 0.2))
    assert (mags > 0).any() and (mags < 0).any()


def test_pool_index_zero_is_never_drawn(monkeypatch):
    """The pool's first entry has weight 0 in the reference's
    ``multinomial(arange(2B))``: mark it and draw many batches."""
    real_cat = torch.cat

    def marked_cat(tensors, *a, **kw):
        pool = real_cat(tensors, *a, **kw)
        pool[0] = 99.0
        return pool

    monkeypatch.setattr(torch, "cat", marked_cat)
    for it in range(200):
        mags = sample_shift_magnitudes(_gen(1, it), 4, 0.1, 0.2)
        assert float(mags.max()) < 1.0
    # Picking B of 2B without replacement: no pool entry twice.
    monkeypatch.undo()
    mags = sample_shift_magnitudes(_gen(2), 64, 0.1, 0.2).numpy()
    assert len(np.unique(mags)) == 64


def test_index_weighting_prefers_the_positive_half():
    """Weights proportional to the pool index favour the later, positive
    entries: with B=8 the expected positive share is well above one half."""
    pos = np.mean([float((sample_shift_magnitudes(_gen(3, it), 8, 0.1, 0.2) > 0).float().mean())
                   for it in range(400)])
    assert 0.58 < pos < 0.75, pos


def test_batch_directives_shapes_and_ranges():
    z, idx, mags = sample_batch_directives(_gen(4), 16, 120, 7, 0.15, 0.25)
    assert z.shape == (16, 120) and z.dtype == torch.float32
    assert idx.shape == (16,) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 7
    assert mags.shape == (16,)
    zt, _, _ = sample_batch_directives(_gen(4), 16, 120, 7, 0.15, 0.25, z_truncation=0.7)
    assert float(zt.abs().max()) <= 0.7


@pytest.mark.parametrize("seed,iteration", [(0, 1), (0, 2), (5, 1)])
def test_stream_is_a_function_of_seed_and_iteration(seed, iteration):
    a = sample_batch_directives(_gen(seed, iteration), 8, 16, 4, 0.1, 0.2)
    gen = torch.Generator()
    torch.randn(100, generator=gen)                       # whatever was drawn before
    b = sample_batch_directives(reseed(gen, seed, iteration), 8, 16, 4, 0.1, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = sample_batch_directives(_gen(seed, iteration + 1), 8, 16, 4, 0.1, 0.2)
    d = sample_batch_directives(_gen(seed + 1, iteration), 8, 16, 4, 0.1, 0.2)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
