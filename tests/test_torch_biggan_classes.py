"""BigGAN's class draw with several target classes, on the CPU.

With more than one ``--biggan-target-classes`` the port draws each row's
class on z's device from an integer hash of z's bits
(``models/biggan.py::class_draw``): no host read, so the draw can sit inside
the CUDA graph of ``--steps-per-call``. These cases hold what the draw must
keep: a pure function of z, the same classes for a code and its shifted code,
every class reached, one class unchanged (and equal to the JAX package's
draw), and a chunk of two steps equal to two single steps. The card's side
(the capture, and the card's draw against this one) is
``tests/test_torch_train_graph_cuda.py::test_biggan_several_classes_graph``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_biggan import N_CLASSES, _latents, small_biggans
from warpedganspace_torch.models.api import GeneratorBundle
from warpedganspace_torch.models.biggan import BigGANGenerator, class_draw
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.train.train_step import (StepChunk, TrainStepConfig, init_train_state,
                                                   metric_row, sample_batch, train_step)

torch.set_num_threads(1)


def _gen(target_classes):
    return small_biggans(32, 16, "32", target_classes=target_classes)[2]


@pytest.mark.parametrize("targets", [(238, 239), (3, 7, 11)])
def test_draw_is_a_pure_function_of_z(targets, monkeypatch):
    gen = _gen(targets)
    z = torch.from_numpy(_latents(5, 16, 120)[0])
    a = gen.mixed_classes(z)
    assert a.dtype == torch.long and a.shape == (16,)
    assert set(a.tolist()) <= set(targets)
    # No host read: neither a copy to the host nor a scalar read is taken.
    def refuse(*args, **kwargs):
        raise AssertionError("the class draw read a value back to the host")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    b = gen.mixed_classes(z.clone())
    monkeypatch.undo()
    assert torch.equal(a, b)
    draws = {tuple(gen.mixed_classes(torch.from_numpy(_latents(s, 16, 120)[0])).tolist())
             for s in range(8)}
    assert len(draws) == 8                           # it does depend on z


@pytest.mark.parametrize("targets", [(238, 239), (3, 7, 11)])
def test_code_and_shifted_code_get_the_same_classes(targets):
    gen = _gen(targets)
    z, shift = (torch.from_numpy(t) for t in _latents(6, 4, 120))
    y = gen.mixed_classes(z)
    with torch.no_grad():
        shifted = gen.apply(z, shift)
        want = gen.apply(z + shift, y=y)
    assert torch.equal(shifted, want)
    # The shifted code's own bits would draw other classes for some rows: the
    # draw is keyed on the unshifted code, not on what the generator renders.
    assert not torch.equal(gen.mixed_classes(z + shift), y) or len(targets) == 1


@pytest.mark.parametrize("n", [2, 3, 5, 1000])
def test_draw_reaches_every_class(n):
    z = torch.from_numpy(_latents(7, 256, 120)[0])
    idx = class_draw(z, n)
    assert idx.min() >= 0 and idx.max() < n
    counts = torch.bincount(idx, minlength=n)
    if n <= 5:
        assert bool((counts > 0).all()), counts
        # Not lopsided: each class gets at least half its share of 256 rows.
        assert int(counts.min()) >= 256 // n // 2, counts
    else:
        assert int((counts > 0).sum()) >= 200


def test_one_class_is_unchanged():
    jgen, _, gen = small_biggans(32, 16, "32", target_classes=(239,))
    z = _latents(8, 8, 120)[0]
    got = gen.mixed_classes(torch.from_numpy(z))
    assert got.tolist() == [239] * 8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgen.mixed_classes(jnp.asarray(z))))


def _state(targets):
    gen = BigGANGenerator(resolution=32, ch=16, shared_dim=16, n_classes=1000,
                          attention="32", target_classes=targets,
                          generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.7)
    G = GeneratorBundle("BigGAN", gen.requires_grad_(False).eval(), dim_z=120,
                        resolution=32, shift_in_w_space=False)
    init = torch.Generator().manual_seed(13)
    S = SupportSets(4, 8, 120, learn_gammas=True, generator=init)
    R = Reconstructor("ResNet", dim=4, channels=3, generator=init)
    cfg = TrainStepConfig(batch_size=8, num_support_sets=4, min_shift_magnitude=0.1,
                          max_shift_magnitude=0.2)
    return init_train_state(G, S, R, cfg, seed=5)


def test_chunk_of_two_steps_equals_two_steps_with_two_classes():
    chunked, single = _state((239, 240)), _state((239, 240))
    rows = StepChunk(chunked, 2)(1)
    want = torch.stack([metric_row(train_step(single, it)) for it in (1, 2)])
    assert torch.equal(rows, want)
    for a, b in zip(chunked.S.parameters(), single.S.parameters()):
        assert torch.equal(a, b)
    for (name, a), b in zip(chunked.R.state_dict().items(), single.R.state_dict().values()):
        assert torch.equal(a, b), name
    # The batches of both steps drew both classes.
    drawn = set()
    for it in (1, 2):
        z = sample_batch(single, it)[0]
        drawn |= set(single.G.net.mixed_classes(z).tolist())
    assert drawn == {239, 240}
