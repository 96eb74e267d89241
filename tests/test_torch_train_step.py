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

The other families take the same step with the same gate: a small
SNGAN-MNIST-shaped generator with the LeNet reconstructor, a 256^2 StyleGAN2
(channel multiplier 1) with shifts in W and truncated codes, whose 64-channel
last block is a tail section and runs the plain section on the CPU, and the
tiny ProgGAN chain whose last six blocks are the tail (the JAX side on its
plain NHWC composition). ``--remat`` recomputes blocks in the backward: its
gradients equal those without it.
"""
import functools
import math

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
METRICS = ("total_loss", "classification_loss", "regression_loss", "accuracy")


def _batch(seed, b=B, dim_z=DIM_Z, truncation=None, mags=(0.1, 0.2)):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, dim_z)).astype(np.float32)
    if truncation is not None:
        z = np.clip(z, -truncation, truncation)
    idx = rng.integers(0, K, b).astype(np.int32)
    mags = (rng.uniform(*mags, b) * rng.choice([-1.0, 1.0], b)).astype(np.float32)
    return z, idx, mags


def _setup_pair(jG, G, rtype, channels, dim_z, seed=0, **cfg_kw):
    """(JAX G, S, R configs and state, port train state) from one set of weights."""
    cfg = dict(CFG, **cfg_kw)
    JS = JSupportSets(K, DIPOLES, dim_z, learn_gammas=True)
    JR = JReconstructor(rtype, dim=K, channels=channels)
    jcfg = j_train_step.TrainStepConfig(**cfg)
    jstate = j_train_step.init_train_state(jax.random.key(seed), jG, JS, JR, jcfg)
    S = SupportSets(K, DIPOLES, dim_z, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jstate["s_params"])))
    R = load_reference_state_dict(
        Reconstructor(rtype, dim=K, channels=channels),
        reconstructor_from_jax(jax.tree_util.tree_map(np.asarray, jstate["r_params"]), rtype))
    state = init_train_state(G, S, R, TrainStepConfig(**cfg))
    return (jG, JS, JR, jcfg, jstate), state


def _setup(rtype, seed=0, **cfg_kw):
    jG, G = small_biggan_bundles(seed=seed)
    return _setup_pair(jG, G, rtype, 3, DIM_Z, seed=seed, **cfg_kw)


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


def _jax_s_grad(jnew):
    """The support sets' gradient of the JAX step just taken: Adam's first
    moment after one step from zero is 0.1 * g."""
    adam = next(x for x in jax.tree_util.tree_leaves(jnew["opt_s"],
                                                     is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    return np.asarray(adam.mu["support_sets"]) / 0.1


def _torch_batch(batch):
    z, idx, mags = batch
    return torch.from_numpy(z), torch.from_numpy(idx).long(), torch.from_numpy(mags)


@pytest.mark.parametrize("rtype", ["ResNet", "LeNet"])
def test_one_step_matches_jax(rtype, monkeypatch):
    jax_side, state = _setup(rtype)
    batch = _batch(1)
    _check_one_step(*_jax_step(jax_side, batch, monkeypatch), state, batch, rtype)


# With a deep generator the port's R and S gradients are held to the JAX
# step's within this share: R's in norm, the sets' of their largest entry.
DEEP_G_GATE = 2e-2


def _deep_g_readings(jnew, jmetrics, state, metrics, rtype):
    """How far the port's step (``metrics``, the gradients ``state`` holds)
    lies from the JAX step: the largest metric difference, R's gradient in
    norm and the sets' gradient of its largest entry, both relative."""
    to_sd = lenet_reconstructor_to_state_dict if rtype == "LeNet" \
        else resnet_reconstructor_to_state_dict
    jgrad = to_sd(_jax_r_grads(jnew))
    pgrad = {n: p.grad.numpy() for n, p in state.R.named_parameters()}
    err = sum(float(np.sum((pgrad[n] - jgrad[n]) ** 2)) for n in pgrad)
    norm = sum(float(np.sum(jgrad[n] ** 2)) for n in pgrad)
    jsets = _jax_s_grad(jnew)
    return {"metrics": max(abs(float(metrics[k]) - float(jmetrics[k])) for k in METRICS),
            "r_grad": math.sqrt(err / norm),
            "s_grad": float(np.abs(state.S.support_sets.grad.numpy() - jsets).max())
            / float(np.abs(jsets).max())}


def _check_one_step(jnew, jmetrics, state, batch, rtype, deep_g=False):
    """The port's step from the state the JAX step ``(jnew, jmetrics)`` took
    on ``batch``; the metrics, the support sets and R after it agree.

    ``deep_g``: the gradients come back through a ResNet-18 R in train mode
    on 64^2 or 256^2 images and a deep generator (StyleGAN2's f32 VJP alone
    agrees to about 6e-4 of its largest entry on the two sides). R's and the
    sets' gradients then agree to 0.6-0.8 % in norm (the BigGAN step above
    measures the same at other batches; its elementwise rule below holds at
    its own seed only), and wherever an entry is below that level, Adam's
    first step (about sign(g) * lr) may take either sign in many places. So
    both are held by their gradients instead: R's within 2 % in norm, the
    sets' within 2 % of their largest entry; every parameter within 2 * lr
    after the step, and the sets within 1e-5 wherever the JAX gradient is
    above 2 % of its largest entry. ``test_deep_g_gate_catches_a_tail_fault``
    reads what a fault in a tail section does to these gradients."""
    alphas0 = state.S.alphas.detach().clone()
    sets0 = state.S.support_sets.detach().clone()
    loggamma0 = state.S.loggamma.detach().clone()
    r0 = {n: p.detach().clone() for n, p in state.R.named_parameters()}
    metrics = train_step(state, 1, batch=_torch_batch(batch))

    for k in METRICS:
        # f32 on both sides through G twice, the warp and R.
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    # After one Adam step of lr 1e-4 (f32).
    js = jax.tree_util.tree_map(np.asarray, jnew["s_params"])
    if deep_g:
        readings = _deep_g_readings(jnew, jmetrics, state, metrics, rtype)
        assert readings["s_grad"] <= DEEP_G_GATE and readings["r_grad"] <= DEEP_G_GATE, readings
        jgrad = _jax_s_grad(jnew)
        scale = float(np.abs(jgrad).max())
        diff = np.abs(state.S.support_sets.detach().numpy() - js["support_sets"])
        assert float(diff.max()) <= 2.1e-4
        assert float(diff[np.abs(jgrad) > 2e-2 * scale].max()) <= 1e-5
    else:
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
    if deep_g:
        for name, p0 in r0.items():
            assert float(np.abs(got[name].numpy() - want[name]).max()) <= 2.1e-4, name
            assert float((got[name] - p0).abs().max()) > 5e-5, name
        assert float(got["features_extractor.bn1.running_mean"].abs().max()) > 0
        return
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


def _sngan_pair():
    from tests.test_torch_sngan import small_sngan_bundles

    return small_sngan_bundles(seed=1), "LeNet", 1, 128, {}


def _sngan_anime_pair():
    """A narrow SNGAN-AnimeFaces chain (64^2 RGB, four up blocks) with the
    LeNet reconstructor on the 6-channel pair and anime.sh's shifts."""
    from tests.test_torch_sngan import small_sngans
    from warpedganspace_tpu.models.api import GeneratorBundle as JBundle
    from warpedganspace_torch.models.api import GeneratorBundle

    jgen, jparams, gen = small_sngans(channels=(32, 32, 16, 16, 16), img_size=64,
                                      image_channels=3, seed=2)
    jG = JBundle(name="SNGAN_AnimeFaces", dim_z=128, resolution=64, out_channels=3,
                 params=jparams, apply_fn=jgen.apply)
    G = GeneratorBundle("SNGAN_AnimeFaces", gen, dim_z=128, resolution=64)
    return (jG, G), "LeNet", 3, 128, dict(min_shift_magnitude=0.25, max_shift_magnitude=0.35)


def _stylegan2_w_pair():
    from warpedganspace_tpu.models.api import GeneratorBundle as JBundle
    from warpedganspace_tpu.models.stylegan2 import StyleGAN2Generator as JStyleGAN2
    from warpedganspace_torch.convert.from_jax import stylegan2_from_jax
    from warpedganspace_torch.models.api import GeneratorBundle
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    kw = dict(resolution=256, n_mlp=2, channel_multiplier=1, shift_in_w_space=True)
    jgen = JStyleGAN2(tail_layout="nhwc", **kw)
    jparams = jgen.init(jax.random.key(2))
    jG = JBundle(name="StyleGAN2", dim_z=512, resolution=256, out_channels=3, params=jparams,
                 apply_fn=jgen.apply, get_w_fn=jgen.get_w, shift_in_w_space=True)
    gen = StyleGAN2Generator(**kw)
    gen.load_state_dict(stylegan2_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    assert len(gen.to_rgbs) - gen.tail_start() == 1          # the 64-channel 256^2 block
    G = GeneratorBundle("StyleGAN2", gen.requires_grad_(False).eval(), dim_z=512,
                        resolution=256, shift_in_w_space=True)
    return (jG, G), "ResNet", 3, 512, dict(shift_in_w_space=True, z_truncation=0.7)


def tiny_stylegan2_w(seed=0):
    """The port's W-space StyleGAN2 at 32² with 128 channels up to 16² and 32
    at 32², so that its last block is a tail section: a CPU training step in
    the family of ``stylegan2.sh`` (truncation, shifts in W, the ResNet
    reconstructor) at a tiny size."""
    from warpedganspace_torch.models import stylegan2
    from warpedganspace_torch.models.api import GeneratorBundle

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stylegan2, "channels_dict",
                   lambda channel_multiplier=2: {4: 128, 8: 128, 16: 128, 32: 32})
        gen = stylegan2.StyleGAN2Generator(resolution=32, n_mlp=2, shift_in_w_space=True,
                                           generator=torch.Generator().manual_seed(seed))
    assert gen.tail_start() == len(gen.to_rgbs) - 1
    return GeneratorBundle("StyleGAN2", gen.requires_grad_(False).eval(), dim_z=512,
                           resolution=32, shift_in_w_space=True)


def _proggan_pair():
    from tests.test_torch_proggan import TINY_CH, small_proggans
    from warpedganspace_tpu.models.api import GeneratorBundle as JBundle
    from warpedganspace_tpu.models.proggan import ProgGANGenerator as JProgGAN
    from warpedganspace_torch.models.api import GeneratorBundle

    jparams, gen = small_proggans(TINY_CH, seed=3)
    assert len(gen.tail_split()[1]) == 3
    jgen = JProgGAN(dim_z=TINY_CH[0], tail_layout="nhwc")
    jG = JBundle(name="ProgGAN", dim_z=TINY_CH[0], resolution=64, out_channels=3,
                 params=jparams, apply_fn=jgen.apply)
    G = GeneratorBundle("ProgGAN", gen.requires_grad_(False).eval(), dim_z=TINY_CH[0],
                        resolution=64)
    return (jG, G), "ResNet", 3, TINY_CH[0], {}


FAMILIES = {"SNGAN_MNIST": (_sngan_pair, B), "SNGAN_AnimeFaces": (_sngan_anime_pair, B),
            "StyleGAN2_W": (_stylegan2_w_pair, 4), "ProgGAN": (_proggan_pair, B)}


@functools.lru_cache(maxsize=None)
def _family_run(family):
    """The small generator of ``family``, its JAX step from the initial state
    on one batch, taken once a process (the step test and the planted-fault
    test read the same), and a builder of the port's state at that start."""
    make, b = FAMILIES[family]
    (jG, G), rtype, channels, dim_z, cfg_kw = make()

    def fresh():
        return _setup_pair(jG, G, rtype, channels, dim_z, batch_size=b, **cfg_kw)

    batch = _batch(4, b=b, dim_z=dim_z, truncation=cfg_kw.get("z_truncation"),
                   mags=(cfg_kw.get("min_shift_magnitude", 0.1),
                         cfg_kw.get("max_shift_magnitude", 0.2)))
    with pytest.MonkeyPatch.context() as mp:
        jnew, jmetrics = _jax_step(fresh()[0], batch, mp)
    return jnew, jmetrics, batch, rtype, lambda: fresh()[1]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_step_matches_jax_per_family(family):
    """The step of ``scripts/train/{mnist,anime,stylegan2,proggan}.sh`` on a
    small generator of each family, against the JAX step: the gate of the
    BigGAN step above (the SNGAN families, with LeNet, at its elementwise rule)."""
    jnew, jmetrics, batch, rtype, state = _family_run(family)
    _check_one_step(jnew, jmetrics, state(), batch, rtype,
                    deep_g=not family.startswith("SNGAN"))


def _tail_fault(family):
    """A wiring fault planted in the tail sections the CPU runs: StyleGAN2's
    ToRGB modulated by the second conv's style, ProgGAN's first section
    without its same-conv bias (the fabricated weights' biases are not 0)."""
    from types import SimpleNamespace

    from warpedganspace_torch.ops.proggan_tail import proggan_tail_plain
    from warpedganspace_torch.ops.sg2_tail import fused_section_plain

    if family == "StyleGAN2_W":
        def section(*ops, want_x2=True):
            return fused_section_plain(*ops[:8], ops[6], *ops[9:], want_x2=want_x2)
        return "warpedganspace_torch.models.stylegan2.fused_section", section

    def tail(x, sections, out):
        (up, same), *rest = sections
        same = SimpleNamespace(weight=same.weight, bias=torch.zeros_like(same.bias),
                               scale=same.scale)
        return proggan_tail_plain(x, [(up, same)] + rest, out)
    return "warpedganspace_torch.models.proggan.proggan_tail", tail


@pytest.mark.parametrize("family", ["StyleGAN2_W", "ProgGAN"])
def test_deep_g_gate_catches_a_tail_fault(family, monkeypatch):
    """The deep generators' gate (``DEEP_G_GATE`` on R's and the sets'
    gradients) separates a faulty step from a sound one: a fault planted in
    a tail section reads at least twice the gate on both gradients and fails
    the metrics' 1e-4, the sound step passes all three. Prints both readings
    (``-s``)."""
    jnew, jmetrics, batch, rtype, fresh = _family_run(family)
    readings = {}
    for name in ("sound", "fault"):
        if name == "fault":
            monkeypatch.setattr(*_tail_fault(family))
        state = fresh()
        metrics = train_step(state, 1, batch=_torch_batch(batch))
        readings[name] = _deep_g_readings(jnew, jmetrics, state, metrics, rtype)
    print(f"{family}: {readings}")
    sound, fault = readings["sound"], readings["fault"]
    assert max(sound["r_grad"], sound["s_grad"]) <= DEEP_G_GATE, readings
    assert sound["metrics"] <= 1e-4, readings
    assert min(fault["r_grad"], fault["s_grad"]) >= 2 * DEEP_G_GATE, readings
    assert fault["metrics"] > 1e-4, readings


@pytest.mark.parametrize("remat", ["tail", "full"])
@pytest.mark.parametrize("family", ["StyleGAN2", "ProgGAN"])
def test_remat_gradients_equal_off(family, remat):
    """``--remat`` recomputes blocks in the backward (``torch.utils.checkpoint``
    on the CPU's plain route) and changes no gradient: the shift's gradient
    through the generator, with its tail on the plain section, is the one of
    ``remat='off'``, bit for bit."""
    from tests.test_torch_proggan import TINY_CH, fabricate_proggan_sd
    from warpedganspace_torch.convert.proggan import load_reference_state_dict as load_proggan
    from warpedganspace_torch.models.proggan import ProgGANGenerator
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    def build(mode):
        if family == "StyleGAN2":
            gen = StyleGAN2Generator(resolution=256, n_mlp=2, channel_multiplier=1,
                                     shift_in_w_space=True, remat=mode,
                                     generator=torch.Generator().manual_seed(5))
            d = 512
        else:
            gen = load_proggan(ProgGANGenerator(dim_z=TINY_CH[0], channels=TINY_CH, remat=mode),
                               fabricate_proggan_sd(TINY_CH, seed=6))
            d = TINY_CH[0]
        return gen.requires_grad_(False).eval(), d

    def shift_grad(mode):
        gen, d = build(mode)
        rng = np.random.default_rng(8)
        z = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
        shift = torch.from_numpy(0.2 * rng.standard_normal((2, d)).astype(np.float32))
        shift.requires_grad_(True)
        img = gen.apply(z, shift)
        w = torch.from_numpy(rng.standard_normal(tuple(img.shape)).astype(np.float32))
        torch.sum(img * w).backward()
        return shift.grad

    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    module = "warpedganspace_torch.models." + ("stylegan2" if family == "StyleGAN2" else "proggan")
    try:
        mp.setattr(module + ".checkpoint", counting)
        ref = shift_grad("off")
        assert not calls
        got = shift_grad(remat)
    finally:
        mp.undo()
    # 'tail' wraps the tail alone (StyleGAN2's one section; ProgGAN's three
    # sections in one call), 'full' every block as well (StyleGAN2's six
    # synthesis blocks; ProgGAN's four head blocks and its tail).
    assert len(calls) == {"StyleGAN2": {"tail": 1, "full": 6},
                          "ProgGAN": {"tail": 1, "full": 5}}[family][remat]
    assert torch.equal(got, ref)


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
