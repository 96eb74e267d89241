"""The port's reconstructor against the JAX package's, on the CPU.

One parameter pytree is made by the JAX package's ``Reconstructor.init`` (with
its BatchNorm statistics and affines perturbed with numpy, so that a wrong
mean, variance, scale or bias would show), converted by
``convert/from_jax.py::reconstructor_from_jax`` and loaded into the port; the
same numpy image pair then goes through both, in eval and in train mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.convert import (lenet_reconstructor_from_state_dict,
                                        lenet_reconstructor_to_state_dict,
                                        resnet_reconstructor_from_state_dict,
                                        resnet_reconstructor_to_state_dict)
from warpedganspace_tpu.models.reconstructor import Reconstructor as JReconstructor
from warpedganspace_torch.convert.from_jax import reconstructor_from_jax
from warpedganspace_torch.convert.reconstructor import (load_reference_state_dict,
                                                        to_reference_state_dict)
from warpedganspace_torch.models.reconstructor import Reconstructor

torch.set_num_threads(1)

K = 5
# (variant, image channels, image size). Batch 8: at 32^2 ResNet-18's last
# stage is 1x1, so its BatchNorm sees 8 values per channel.
CASES = [("ResNet", 3, 32), ("LeNet", 1, 32), ("LeNet", 3, 64)]


def _perturbed(params, rng):
    """The pytree as numpy, with every BatchNorm's four leaves moved off their init."""
    def walk(tree):
        if isinstance(tree, dict):
            if "mean" in tree and "var" in tree:
                c = tree["mean"].shape[0]
                return {"scale": rng.uniform(0.7, 1.3, c).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "var": rng.uniform(0.6, 1.5, c).astype(np.float32)}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return np.asarray(tree)
    return walk(params)


def _pair(rtype, channels, size, seed=0):
    JR = JReconstructor(rtype, dim=K, channels=channels)
    rng = np.random.default_rng(seed)
    params = _perturbed(JR.init(jax.random.key(seed)), rng)
    R = Reconstructor(rtype, dim=K, channels=channels)
    load_reference_state_dict(R, reconstructor_from_jax(params, rtype))
    x1, x2 = (rng.uniform(-1, 1, (8, size, size, channels)).astype(np.float32) for _ in range(2))
    return JR, jax.tree_util.tree_map(jnp.asarray, params), R, x1, x2


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _bn_leaves(params):
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            if "mean" in tree and "var" in tree:
                out.append((path, np.asarray(tree["mean"]), np.asarray(tree["var"])))
            else:
                for k, v in tree.items():
                    walk(v, f"{path}.{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}.{i}")
    walk(params, "")
    return out


@pytest.mark.parametrize("rtype,channels,size", CASES)
def test_eval_matches_jax(rtype, channels, size):
    JR, jparams, R, x1, x2 = _pair(rtype, channels, size)
    jl, jm = JR.apply(jparams, jnp.asarray(x1), jnp.asarray(x2), train=False)
    with torch.no_grad():
        logits, mags = R.eval()(_nchw(x1), _nchw(x2))
    assert tuple(logits.shape) == (8, K) and tuple(mags.shape) == (8,)
    # f32 on both sides, sums in another order through up to 20 layers.
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mags.numpy(), np.asarray(jm), rtol=0, atol=1e-4)


@pytest.mark.parametrize("rtype,channels,size", CASES)
def test_train_mode_matches_jax_and_refreshes_statistics(rtype, channels, size):
    JR, jparams, R, x1, x2 = _pair(rtype, channels, size, seed=1)
    jl, jm, jnew = JR.apply(jparams, jnp.asarray(x1), jnp.asarray(x2), train=True)
    before = {k: v.clone() for k, v in R.state_dict().items()}
    logits, mags = R.train()(_nchw(x1), _nchw(x2))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mags.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-4)
    # The refreshed running statistics, through the export both packages share.
    to_sd = lenet_reconstructor_to_state_dict if rtype == "LeNet" \
        else resnet_reconstructor_to_state_dict
    want = to_sd(jax.tree_util.tree_map(np.asarray, jnew))
    got = R.state_dict()
    moved = 0
    for name, ref in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=0, atol=1e-5, err_msg=name)
            moved += int(not torch.equal(got[name], before[name]))
    assert moved == sum(k.endswith(("running_mean", "running_var")) for k in want)
    # Gradients reach every parameter, and the weights' values did not move.
    (logits.sum() + mags.sum()).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in R.parameters())
    assert all(torch.equal(p, before[n]) for n, p in R.named_parameters())


# ResNet at 64^2: at 32^2 its last stage's BatchNorm takes its moments over 8
# values per channel in train mode and amplifies bf16 rounding to 0.1 in
# either package against its own f32.
@pytest.mark.parametrize("rtype,channels,size", [("ResNet", 3, 64), ("LeNet", 1, 32)])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_trunk_follows_jax(rtype, channels, size, train):
    JR, jparams, R, x1, x2 = _pair(rtype, channels, size, seed=2)
    out = JR.apply(jparams, jnp.asarray(x1), jnp.asarray(x2), train=train, dtype=jnp.bfloat16)
    R.train(train)
    with torch.no_grad():
        logits, mags = R(_nchw(x1), _nchw(x2), dtype=torch.bfloat16)
    assert logits.dtype == torch.float32 and mags.dtype == torch.float32   # float32 heads
    assert all(p.dtype == torch.float32 for p in R.parameters())           # float32 masters
    # bf16 convolutions round at other places in the two frameworks.
    np.testing.assert_allclose(logits.numpy(), np.asarray(out[0]), rtol=0, atol=5e-2)
    np.testing.assert_allclose(mags.numpy(), np.asarray(out[1]), rtol=0, atol=5e-2)
    # And the bf16 trunk stays near the f32 one.
    with torch.no_grad():
        l32, m32 = R(_nchw(x1), _nchw(x2))
    np.testing.assert_allclose(logits.numpy(), l32.numpy(), rtol=0, atol=1e-1)


@pytest.mark.parametrize("rtype,channels", [("ResNet", 3), ("LeNet", 1)])
def test_state_dict_round_trip_through_both_converters(rtype, channels):
    """The port's ``state_dict()`` is the reference file format: the JAX
    package's importer reads it, its exporter writes what the port loads, and
    both name the same keys with the same shapes."""
    JR, jparams, R, x1, x2 = _pair(rtype, channels, 32, seed=3)
    from_sd, to_sd = ((lenet_reconstructor_from_state_dict, lenet_reconstructor_to_state_dict)
                      if rtype == "LeNet" else
                      (resnet_reconstructor_from_state_dict, resnet_reconstructor_to_state_dict))
    exported = to_reference_state_dict(R)
    jax_sd = to_sd(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(exported) == set(jax_sd)
    for name, v in exported.items():
        assert tuple(v.shape) == tuple(np.shape(jax_sd[name])), name
    # port -> JAX: the same forward.
    back = from_sd({k: v.numpy() for k, v in exported.items()})
    jl, _ = JR.apply(back, jnp.asarray(x1), jnp.asarray(x2), train=False)
    jl0, _ = JR.apply(jparams, jnp.asarray(x1), jnp.asarray(x2), train=False)
    np.testing.assert_allclose(np.asarray(jl), np.asarray(jl0), rtol=0, atol=1e-6)
    # JAX -> port, as numpy arrays, with torchvision's unused fc head beside it.
    extra = {"features_extractor.fc.weight": np.zeros((1000, 512), np.float32),
             "features_extractor.fc.bias": np.zeros(1000, np.float32)} if rtype == "ResNet" else {}
    R2 = load_reference_state_dict(Reconstructor(rtype, dim=K, channels=channels),
                                   {**jax_sd, **extra})
    for (name, a), (_, b) in zip(R.state_dict().items(), R2.state_dict().items()):
        assert torch.equal(a, b), name
    with pytest.raises(KeyError, match="does not fit"):
        load_reference_state_dict(Reconstructor("LeNet" if rtype == "ResNet" else "ResNet",
                                                dim=K, channels=channels), jax_sd)


def test_seeded_init_and_unknown_type():
    a, b = (Reconstructor("ResNet", dim=3, generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    w = a.features_extractor.conv1.weight
    assert tuple(w.shape) == (64, 6, 7, 7)
    # kaiming-normal, fan_out: std = sqrt(2 / (64 * 49)).
    assert abs(float(w.detach().std()) - (2.0 / (64 * 49)) ** 0.5) < 2e-3
    with pytest.raises(ValueError, match="unknown reconstructor type"):
        Reconstructor("VGG", dim=3)
