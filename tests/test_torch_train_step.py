"""One whole training step of the port against the JAX package's, on the CPU.

A small BigGAN with its attention block open (the fabricated ``G_ema``
checkpoint of ``tests/test_torch_biggan.py``, gammas 0.7 and up), the same
initial support sets and reconstructor (made by the JAX package, converted by
``convert/from_jax.py``) and the same batch (z, idx, mags), made with numpy and
handed to both: the JAX step through a patched ``sample_batch_directives`` (a
name in this process; no file changes), the port's through its ``batch``
argument. On the CPU the port's attention runs its plain version and autograd
differentiates it; the JAX step takes its own route (the Pallas kernels in
interpret mode where the shapes fit, jnp otherwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_traverse import small_biggan_bundles
from warpedganspace_tpu.convert import (lenet_reconstructor_to_state_dict,
                                        resnet_reconstructor_to_state_dict)
from warpedganspace_tpu.models.reconstructor import Reconstructor as JReconstructor
from warpedganspace_tpu.models.support_sets import SupportSets as JSupportSets
from warpedganspace_tpu.train import train_step as j_train_step
from warpedganspace_torch.convert.from_jax import reconstructor_from_jax, support_sets_from_jax
from warpedganspace_torch.convert.reconstructor import load_reference_state_dict
from warpedganspace_torch.models.reconstructor import Reconstructor
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.train.train_step import (TrainStepConfig, init_train_state, loss_fn,
                                                   make_optimizers, train_step)

torch.set_num_threads(1)

K, DIPOLES, B, DIM_Z = 4, 3, 8, 120
CFG = dict(batch_size=B, num_support_sets=K, min_shift_magnitude=0.1, max_shift_magnitude=0.2)


def _batch(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, DIM_Z)).astype(np.float32)
    idx = rng.integers(0, K, B).astype(np.int32)
    mags = (rng.uniform(0.1, 0.2, B) * rng.choice([-1.0, 1.0], B)).astype(np.float32)
    return z, idx, mags


def _setup(rtype, seed=0, **cfg_kw):
    """(JAX G, S, R configs and state, port train state) from one set of weights."""
    jG, G = small_biggan_bundles(seed=seed)
    JS = JSupportSets(K, DIPOLES, DIM_Z, learn_gammas=True)
    JR = JReconstructor(rtype, dim=K, channels=3)
    jcfg = j_train_step.TrainStepConfig(**CFG, **cfg_kw)
    jstate = j_train_step.init_train_state(jax.random.key(seed), jG, JS, JR, jcfg)
    S = SupportSets(K, DIPOLES, DIM_Z, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jstate["s_params"])))
    R = load_reference_state_dict(
        Reconstructor(rtype, dim=K, channels=3),
        reconstructor_from_jax(jax.tree_util.tree_map(np.asarray, jstate["r_params"]), rtype))
    state = init_train_state(G, S, R, TrainStepConfig(**CFG, **cfg_kw))
    return (jG, JS, JR, jcfg, jstate), state


def _jax_step(jax_side, batch, monkeypatch):
    jG, JS, JR, jcfg, jstate = jax_side
    z, idx, mags = (jnp.asarray(x) for x in batch)
    monkeypatch.setattr(j_train_step, "sample_batch_directives", lambda *a, **kw: (z, idx, mags))
    step = j_train_step.make_train_step(jG, JS, JR, jcfg, donate=False)
    return step(jstate, jG.params, jax.random.key(0), 1)


def _jax_r_grads(jnew):
    """The reconstructor's gradient of the JAX step just taken, in the layout of
    its parameters: Adam's first moment after one step from zero is 0.1 * g.
    Leaves the optimizer masks (BatchNorm's running statistics) read as zero."""
    adam = next(x for x in jax.tree_util.tree_leaves(jnew["opt_r"],
                                                     is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    masked = lambda x: type(x).__name__ == "MaskedNode"  # noqa: E731
    mu = {jax.tree_util.keystr(path): np.asarray(leaf) / 0.1
          for path, leaf in jax.tree_util.tree_flatten_with_path(adam.mu, is_leaf=masked)[0]
          if not masked(leaf)}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jnew["r_params"])
    return jax.tree_util.tree_unflatten(
        treedef, [mu.get(jax.tree_util.keystr(path), np.zeros(np.shape(leaf), np.float32))
                  for path, leaf in leaves])


def _torch_batch(batch):
    z, idx, mags = batch
    return torch.from_numpy(z), torch.from_numpy(idx).long(), torch.from_numpy(mags)


@pytest.mark.parametrize("rtype", ["ResNet", "LeNet"])
def test_one_step_matches_jax(rtype, monkeypatch):
    jax_side, state = _setup(rtype)
    batch = _batch(1)
    jnew, jmetrics = _jax_step(jax_side, batch, monkeypatch)
    alphas0 = state.S.alphas.detach().clone()
    sets0 = state.S.support_sets.detach().clone()
    loggamma0 = state.S.loggamma.detach().clone()
    r0 = {n: p.detach().clone() for n, p in state.R.named_parameters()}
    metrics = train_step(state, 1, batch=_torch_batch(batch))

    for k in ("total_loss", "classification_loss", "regression_loss", "accuracy"):
        # f32 on both sides through G twice, the warp and R.
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    # After one Adam step of lr 1e-4 (f32).
    js = jax.tree_util.tree_map(np.asarray, jnew["s_params"])
    np.testing.assert_allclose(state.S.support_sets.detach().numpy(), js["support_sets"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.S.loggamma.detach().numpy(), js["loggamma"], rtol=0, atol=1e-5)
    assert torch.equal(state.S.alphas, alphas0)                    # frozen: unmoved
    np.testing.assert_array_equal(js["alphas"], alphas0.numpy())
    assert float((state.S.support_sets.detach() - sets0).abs().max()) > 0   # trained: moved
    assert float((state.S.loggamma.detach() - loggamma0).abs().max()) > 0
    to_sd = lenet_reconstructor_to_state_dict if rtype == "LeNet" \
        else resnet_reconstructor_to_state_dict
    want = to_sd(jax.tree_util.tree_map(np.asarray, jnew["r_params"]))
    got = state.R.state_dict()
    # Adam turns a gradient near zero into a step of about sign(g) * lr, so a
    # sum taken in another order can flip an element by up to 2 * lr. A leaf
    # whose gradient in the reference is zero but for rounding (a bias that
    # feeds a BatchNorm: below 1e-4 of R's largest gradient entry, where the
    # smallest real one is above 1e-3 of it) is held to 2 * lr only, and must
    # have such a gradient in the port too. Of all other elements at most one in 10,000 may be such
    # a flip; the rest agree within 1e-5.
    jgrad = to_sd(_jax_r_grads(jnew))
    pgrad = {n: p.grad.numpy() for n, p in state.R.named_parameters()}
    tiny = 1e-4 * max(float(np.abs(g).max()) for g in jgrad.values())
    n_far = n_all = 0
    zero_grad = []
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = np.abs(got[name].numpy() - ref)
        assert float(diff.max()) <= 2.1e-4, (name, float(diff.max()))
        if name in pgrad and float(np.abs(jgrad[name]).max()) <= tiny:
            assert float(np.abs(pgrad[name]).max()) <= tiny, name
            zero_grad.append(name)
            continue
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    # LeNet's three conv biases and two first head biases feed a BatchNorm;
    # every ResNet leaf has a real gradient.
    assert len(zero_grad) == (5 if rtype == "LeNet" else 0), zero_grad
    # Every trained leaf moved, by about lr where its gradient is real.
    for name, p0 in r0.items():
        if name not in zero_grad:
            assert float((got[name] - p0).abs().max()) > 5e-5, name
    # BatchNorm statistics were refreshed by the train-mode forward.
    stat = "feature_extractor.1.running_mean" if rtype == "LeNet" \
        else "features_extractor.bn1.running_mean"
    assert float(got[stat].abs().max()) > 0


def test_attention_is_on_the_gradient_path():
    """With the attention's gamma at 0 (the random init) its backward gets a
    zero cotangent and any backward would pass; the checkpoint used here opens
    it, and closing it changes the support sets' gradient."""
    _, state = _setup("LeNet")
    z, idx, mags = _torch_batch(_batch(2))

    def grad_of_sets():
        state.S.zero_grad()
        loss_fn(state.S, state.R, state.G, z, idx, mags, state.cfg)[0].backward()
        return state.S.support_sets.grad.clone()

    open_grad = grad_of_sets()
    attention = [blk.attention for blk in state.G.net.blocks if blk.attention is not None]
    assert attention and all(float(a.gamma) != 0 for a in attention)
    with torch.no_grad():
        for a in attention:
            a.gamma.zero_()
    assert float((grad_of_sets() - open_grad).abs().max()) > 1e-6


def test_loss_falls_on_one_batch():
    """Stepping repeatedly on one batch overfits it: the whole gradient path
    through the frozen G into S and R works."""
    _, state = _setup("LeNet", support_set_lr=3e-3, reconstructor_lr=3e-3)
    batch = _torch_batch(_batch(3))
    losses = [float(train_step(state, 1, batch=batch)["total_loss"]) for _ in range(40)]
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    assert not any(p.requires_grad for p in state.G.parameters())


def test_mixed_precision_step_and_sampled_batch():
    """bf16 G and R: the step stays finite and near the f32 loss, the masters
    stay float32, and without ``batch`` the step draws (seed, iteration)'s."""
    _, s32 = _setup("ResNet")
    _, s16 = _setup("ResNet", generator_dtype="bfloat16", reconstructor_dtype="bfloat16")
    assert next(s16.G.parameters()).dtype == torch.bfloat16
    m32 = train_step(s32, 5)
    m16 = train_step(s16, 5)
    assert all(bool(torch.isfinite(v)) for v in m16.values())
    np.testing.assert_allclose(float(m16["total_loss"]), float(m32["total_loss"]), rtol=0.05)
    assert all(p.dtype == torch.float32 for p in list(s16.R.parameters()) + list(s16.S.parameters()))
    # The same (seed, iteration) again draws the same batch: the same loss on fresh states.
    _, again = _setup("ResNet")
    assert float(train_step(again, 5)["total_loss"]) == float(m32["total_loss"])
    _, other = _setup("ResNet")
    assert float(train_step(other, 6)["total_loss"]) != float(m32["total_loss"])


def test_optimizers_take_only_what_trains():
    S = SupportSets(K, DIPOLES, DIM_Z, learn_gammas=False)
    R = Reconstructor("LeNet", dim=K)
    opt_s, opt_r = make_optimizers(S, R, TrainStepConfig(**CFG))
    assert [tuple(p.shape) for g in opt_s.param_groups for p in g["params"]] == \
        [(K, 2 * DIPOLES, DIM_Z)]
    n_r = sum(len(g["params"]) for g in opt_r.param_groups)
    assert n_r == len(list(R.parameters())) and not any(
        "running" in n for n, _ in R.named_parameters())
    S2 = SupportSets(K, DIPOLES, DIM_Z, learn_alphas=True, learn_gammas=True)
    opt_s2, _ = make_optimizers(S2, R, TrainStepConfig(**CFG))
    assert sum(len(g["params"]) for g in opt_s2.param_groups) == 3
