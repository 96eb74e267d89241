"""A chunk of two steps of the port against the JAX package's scan of two, on
the CPU, for the 1024² experiments' families (``--steps-per-call``).

The small StyleGAN2 in W space (256², channel multiplier 1, its 64-channel
last block a tail section) and the tiny ProgGAN chain (its last six blocks the
tail) of ``tests/test_torch_train_step.py::FAMILIES``, each with the ResNet
reconstructor, start from one state on both sides. Two batches made with
numpy go into both: the port's :class:`StepChunk` (k=2; on the CPU two eager
steps) reads them through a patched ``sample_batch``, the JAX package's
``make_train_step_scan(k=2)`` through a patched ``sample_batch_directives``
that indexes the stacked batches by the iteration the scan traces.

Each step is held at the one-step gate of the deep generators
(``tests/test_torch_train_step.py::_check_one_step(..., deep_g=True)``): its
metrics within 1e-4, R's and the sets' gradient within ``DEEP_G_GATE`` (2 %)
of JAX's, R's in norm and the sets' of their largest entry; after it every
trained parameter within 2 * lr + 1e-5 of JAX's (Adam's first steps are about
sign(g) * lr, so an element whose gradient lies within that 2 % takes either
sign: the rule of ``tests/test_torch_parallel.py`` for the leaves whose
gradient is zero but for rounding, here for every leaf), the sets within 1e-5
where JAX's gradient is firm, loggamma within 1e-5, the alphas unmoved, R's
running statistics within 1e-3 of each one's largest magnitude. The JAX
gradients are read from Adam's first moments (m1 = 0.1 g1, m2 = 0.9 m1 +
0.1 g2).

Between the chunk's two steps the port's S and R are set to JAX's after its
first step (the Adams keep their own moments). Without that the second step
starts from states that differ wherever Adam's first step took opposite
signs, and R in train mode on four rows amplifies those 2 * lr: on StyleGAN2
the second step's metrics then lie 1.5e-4 and R's gradient 10 % from the
scan's, while JAX's scan and two calls of JAX's single step lie 6e-7 and
5e-6 apart. With it, what the chunk carries from its first step to its
second (the Adams' moments and step counts, which batch it reads) is held at
the gate. The state after the chunk is held to the scan's as the one-step
state is: within 2 * lr (the second step's update; the moments of the first
step differ where its signs did), the sets within 1e-5 where both of JAX's
gradients exceed 20 % of their largest entry (there the update
m2 / sqrt(v2) depends on their ratio, which 2 % of the largest entry moves
by up to a tenth).
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import DEEP_G_GATE, FAMILIES, METRICS, _batch, _setup_pair
from warpedganspace_tpu.convert import resnet_reconstructor_to_state_dict
from warpedganspace_tpu.train import train_step as j_train_step
from warpedganspace_torch.convert.from_jax import reconstructor_from_jax, support_sets_from_jax
from warpedganspace_torch.convert.reconstructor import load_reference_state_dict
from warpedganspace_torch.train.train_step import StepChunk

# The module (the package re-exports the function under its name).
t_train_step = importlib.import_module("warpedganspace_torch.train.train_step")

torch.set_num_threads(1)

K_CHUNK = 2
LR = 1e-4
ATOL_PARAMS = 2 * LR + 1e-5
ATOL_FIRM = 1e-5
RUNNING_STAT_SHARE = 1e-3
FIRM_SHARE = 0.2


def _jax_steps(jax_side, batches, scan):
    """JAX's steps from ``jax_side``'s state on ``batches``: one
    ``make_train_step_scan(k=len(batches))`` call (``scan``), else one call
    of ``make_train_step`` on the first batch. Either way the patched
    ``sample_batch_directives`` indexes the stacked batches by the iteration
    the step traces (1, 2, ...). Returns (state, metrics)."""
    jG, JS, JR, jcfg, jstate = jax_side
    stacked = tuple(jnp.asarray(np.stack(parts)) for parts in zip(*batches))
    iteration = {}
    real_make = j_train_step._make_raw_step

    def make_raw(*args, **kwargs):
        raw = real_make(*args, **kwargs)

        def step(state, g_params, seed_key, it):
            iteration["it"] = it
            return raw(state, g_params, seed_key, it)
        return step

    def directives(*args, **kwargs):
        return tuple(a[iteration["it"] - 1] for a in stacked)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_train_step, "_make_raw_step", make_raw)
        mp.setattr(j_train_step, "sample_batch_directives", directives)
        if scan:
            step = j_train_step.make_train_step_scan(jG, JS, JR, jcfg, k=len(batches),
                                                     donate=False)
        else:
            step = j_train_step.make_train_step(jG, JS, JR, jcfg, donate=False)
        return step(jstate, jG.params, jax.random.key(0), 1)


def _jax_adam_mu(jnew, name):
    """Adam's first moment of ``opt_s`` or ``opt_r`` in the JAX state ``jnew``."""
    return next(x for x in jax.tree_util.tree_leaves(jnew[name],
                                                     is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu")).mu


def _jax_grads(first, second):
    """The sets' and R's gradients (R's by reference-layout name) of the step
    that led to the JAX state ``second``, from Adam's first moments: of the
    first step when ``first`` is None, else of the step after ``first``."""
    masked = lambda x: type(x).__name__ == "MaskedNode"  # noqa: E731

    def moments(jnew):
        mu = {jax.tree_util.keystr(path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  _jax_adam_mu(jnew, "opt_r"), is_leaf=masked)[0] if not masked(leaf)}
        leaves, treedef = jax.tree_util.tree_flatten_with_path(jnew["r_params"])
        r = resnet_reconstructor_to_state_dict(jax.tree_util.tree_unflatten(
            treedef, [mu.get(jax.tree_util.keystr(path), np.zeros(np.shape(leaf), np.float32))
                      for path, leaf in leaves]))
        return np.asarray(_jax_adam_mu(jnew, "opt_s")["support_sets"]), r

    s2, r2 = moments(second)
    if first is None:
        return s2 / 0.1, {n: v / 0.1 for n, v in r2.items()}
    s1, r1 = moments(first)
    return (s2 - 0.9 * s1) / 0.1, {n: (v - 0.9 * r1[n]) / 0.1 for n, v in r2.items()}


def _resync(state, jnew, rtype):
    """Set the port's S and R (parameters and statistics) to the JAX state's,
    in place: the optimisers keep their tensors."""
    S_sd = support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jnew["s_params"]))
    with torch.no_grad():
        state.S.from_torch_state_dict(S_sd)
    load_reference_state_dict(state.R, reconstructor_from_jax(
        jax.tree_util.tree_map(np.asarray, jnew["r_params"]), rtype))


@functools.lru_cache(maxsize=None)
def _chunk_run(family):
    """From one start: JAX's scan of two, JAX's single step on the first
    batch, and the port's chunk of two with its state set to that single
    step's between its steps (the gradients each step handed to Adam kept)."""
    make, b = FAMILIES[family]
    (jG, G), rtype, channels, dim_z, cfg_kw = make()
    batches = tuple(_batch(seed, b=b, dim_z=dim_z, truncation=cfg_kw.get("z_truncation"),
                           mags=(cfg_kw.get("min_shift_magnitude", 0.1),
                                 cfg_kw.get("max_shift_magnitude", 0.2)))
                    for seed in (4, 5))
    jax_side, state = _setup_pair(jG, G, rtype, channels, dim_z, batch_size=b, **cfg_kw)
    scan = _jax_steps(jax_side, batches, scan=True)
    single = _jax_steps(jax_side, batches, scan=False)

    start = {"S": {k: v.detach().clone() for k, v in state.S.state_dict().items()},
             "R": {k: v.detach().clone() for k, v in state.R.state_dict().items()}}
    grads = []
    real_step = t_train_step.train_step

    def step_and_resync(st, iteration, batch=None):
        metrics = real_step(st, iteration, batch=batch)
        grads.append((st.S.support_sets.grad.detach().numpy().copy(),
                      {n: p.grad.detach().numpy().copy() for n, p in st.R.named_parameters()}))
        if len(grads) == 1:
            _resync(st, single[0], rtype)
        return metrics

    torch_batches = [(torch.from_numpy(z), torch.from_numpy(i).long(), torch.from_numpy(m))
                     for z, i, m in batches]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_train_step, "sample_batch", lambda st, it: torch_batches[it - 1])
        mp.setattr(t_train_step, "train_step", step_and_resync)
        rows = StepChunk(state, K_CHUNK)(1)
    return {"scan": scan, "single": single, "state": state, "rows": rows, "grads": grads,
            "start": start}


def _rel(got, want):
    """|got - want| / |want| in norm over dicts of arrays."""
    err = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    return math.sqrt(err / sum(float(np.sum(want[n] ** 2)) for n in want))


def _step_readings(metrics, grads, ref_metrics, ref_grads):
    """The largest metric difference, R's gradient relative in norm and the
    sets' relative to their largest entry."""
    (s, r), (ref_s, ref_r) = grads, ref_grads
    return {"metrics": max(abs(metrics[m] - ref_metrics[m]) for m in METRICS),
            "r_grad": _rel(r, {n: ref_r[n] for n in r}),
            "s_grad": float(np.abs(s - ref_s).max()) / float(np.abs(ref_s).max())}


def _check_state(state, jnew, firm, start):
    """The port's S and R against the JAX state ``jnew`` at the gate above."""
    js = jax.tree_util.tree_map(np.asarray, jnew["s_params"])
    sets = np.abs(state.S.support_sets.detach().numpy() - js["support_sets"])
    assert float(sets.max()) <= ATOL_PARAMS
    assert firm.any() and float(sets[firm].max()) <= ATOL_FIRM
    np.testing.assert_allclose(state.S.loggamma.detach().numpy(), js["loggamma"], rtol=0,
                               atol=ATOL_FIRM)
    assert torch.equal(state.S.alphas, start["S"]["alphas"])
    want = resnet_reconstructor_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                     jnew["r_params"]))
    got = state.R.state_dict()
    trained = {n for n, _ in state.R.named_parameters()}
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = float(np.abs(got[name].numpy() - ref).max())
        if name in trained:
            assert diff <= ATOL_PARAMS, (name, diff)
            assert float((got[name] - start["R"][name]).abs().max()) > 5e-5, name
        else:
            assert diff <= RUNNING_STAT_SHARE * float(np.abs(ref).max()), (name, diff)


@pytest.mark.parametrize("family", ["StyleGAN2_W", "ProgGAN"])
def test_chunk_of_two_matches_jax_scan(family):
    run = _chunk_run(family)
    (scan, scan_metrics), (single, single_metrics) = run["scan"], run["single"]
    rows = run["rows"]
    assert rows.shape == (K_CHUNK, 4) and bool(torch.isfinite(rows).all())
    assert len(run["grads"]) == K_CHUNK
    port = [{m: float(rows[i, j]) for j, m in enumerate(t_train_step.STAT_KEYS)}
            for i in range(K_CHUNK)]
    scan_rows = [{m: float(scan_metrics[m][i]) for m in METRICS} for i in range(K_CHUNK)]
    # The scan's first step is JAX's single step.
    assert max(abs(scan_rows[0][m] - float(single_metrics[m])) for m in METRICS) <= 1e-6
    jax_grads = [_jax_grads(None, single), _jax_grads(single, scan)]
    readings = [_step_readings(port[i], run["grads"][i], scan_rows[i], jax_grads[i])
                for i in range(K_CHUNK)]
    print(f"{family}: each step of the chunk against the scan's: {readings}")
    for r in readings:
        assert r["metrics"] <= 1e-4, readings
        assert r["r_grad"] <= DEEP_G_GATE and r["s_grad"] <= DEEP_G_GATE, readings
    firm = np.ones(jax_grads[0][0].shape, bool)
    for g, _ in jax_grads:
        firm &= np.abs(g) > FIRM_SHARE * float(np.abs(g).max())
    _check_state(run["state"], scan, firm, run["start"])
