"""The port's StyleGAN2 and BigGAN discriminators, and BigGAN's G_D pair,
against the JAX package's, on the CPU (the card's side is
``tests/test_torch_discriminators_cuda.py``).

Each discriminator is loaded twice: from the JAX package's own parameters
through ``convert/from_jax.py`` (biases and attention gammas moved away from
their zero init, so that a dropped term shows), and from one reference-layout
``state_dict`` fabricated with numpy, which the JAX converter and the port's
converter each read (equalized-lr scales and the spectral norm, from stored
``u0`` vectors, folded on both sides). The same images and classes then go
through both. The gate: the largest difference of the logits within 1e-4 of
their largest magnitude, in float32.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_biggan import N_CLASSES, small_biggans
from tests.test_torch_discriminators_cuda import fabricate_biggan_d
from warpedganspace_tpu.convert.biggan import biggan_d_params_from_state_dict
from warpedganspace_tpu.convert.stylegan2 import stylegan2_discriminator_params_from_state_dict
from warpedganspace_tpu.models.biggan import BigGAN_GD as JGD
from warpedganspace_tpu.models.biggan import BigGANDiscriminator as JBigGAND
from warpedganspace_tpu.models.biggan import biggan_d_arch as j_biggan_d_arch
from warpedganspace_tpu.models.stylegan2 import StyleGAN2Discriminator as JSG2D
from warpedganspace_tpu.models.stylegan2 import channels_dict
from warpedganspace_torch.convert.biggan import biggan_d_state_dict_from_reference
from warpedganspace_torch.convert.from_jax import (biggan_d_from_jax,
                                                   stylegan2_discriminator_from_jax)
from warpedganspace_torch.convert.stylegan2 import (
    stylegan2_discriminator_state_dict_from_reference)
from warpedganspace_torch.models.biggan import (BigGAN_GD, BigGANDiscriminator,
                                                biggan_d_arch)
from warpedganspace_torch.models.stylegan2 import StyleGAN2Discriminator

torch.set_num_threads(1)

RTOL = 1e-4


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def _perturbed(params, seed, scale=0.05):
    """The JAX pytree as numpy, each leaf moved by seeded noise: biases and
    attention gammas leave their zero init."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x, np.float32) + np.float32(scale) * rng.standard_normal(
        np.shape(x)).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _images(seed, b, res):
    return np.random.default_rng(seed).standard_normal((b, 3, res, res)).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


# ------------------------------------------------------------------ StyleGAN2
def fabricate_stylegan2_d(resolution, channel_multiplier, seed=0):
    """A reference-layout StyleGAN2 Discriminator ``state_dict`` (model.py:453-503)
    as numpy arrays: unit-normal EqualConv2d/EqualLinear weights, as the
    reference initialises them, and random biases."""
    rng = np.random.default_rng(seed)
    ch = channels_dict(channel_multiplier)
    sd = {}

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    def conv(prefix, cin, cout, k, bias_key=None):
        sd[prefix + ".weight"] = f32(rng.standard_normal((cout, cin, k, k)))
        if bias_key:
            sd[bias_key] = f32(0.1 * rng.standard_normal(cout))

    conv("convs.0.0", 3, ch[resolution], 1, "convs.0.1.bias")
    in_ch = ch[resolution]
    for j, i in enumerate(range(int(math.log2(resolution)), 2, -1), start=1):
        out_ch, pre = ch[2 ** (i - 1)], f"convs.{j}"
        conv(pre + ".conv1.0", in_ch, in_ch, 3, pre + ".conv1.1.bias")
        conv(pre + ".conv2.1", in_ch, out_ch, 3, pre + ".conv2.2.bias")
        conv(pre + ".skip.1", in_ch, out_ch, 1)
        in_ch = out_ch
    conv("final_conv.0", in_ch + 1, ch[4], 3, "final_conv.1.bias")
    for name, (i, o) in (("final_linear.0", (ch[4] * 16, ch[4])), ("final_linear.1", (ch[4], 1))):
        sd[name + ".weight"] = f32(rng.standard_normal((o, i)))
        sd[name + ".bias"] = f32(0.1 * rng.standard_normal(o))
    return sd


SG2_CASES = [(64, 1, 4), (256, 2, 2)]     # resolution, channel multiplier, batch


@pytest.mark.parametrize("resolution,cm,b", SG2_CASES)
def test_stylegan2_d_matches_jax_from_reference_layout(resolution, cm, b):
    sd = fabricate_stylegan2_d(resolution, cm, seed=resolution)
    jd = JSG2D(resolution=resolution, channel_multiplier=cm)
    jparams = stylegan2_discriminator_params_from_state_dict(sd, resolution)
    d = StyleGAN2Discriminator(resolution, cm)
    d.load_state_dict(stylegan2_discriminator_state_dict_from_reference(sd, resolution))
    x = _images(1, b, resolution)
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    _assert_logits_close(got, jd.apply(jparams, _nhwc(x)))
    assert got.shape == (b, 1)


@pytest.mark.parametrize("resolution,cm,b", SG2_CASES)
def test_stylegan2_d_matches_jax_through_from_jax(resolution, cm, b):
    jd = JSG2D(resolution=resolution, channel_multiplier=cm)
    jparams = _perturbed(jd.init(jax.random.key(resolution)), seed=cm)
    d = StyleGAN2Discriminator(resolution, cm)
    d.load_state_dict(stylegan2_discriminator_from_jax(jparams))
    x = _images(2, b, resolution)
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    _assert_logits_close(got, jd.apply(jparams, _nhwc(x)))


def test_stylegan2_d_flattens_nchw():
    """The head's first linear reads the 4x4 map in NCHW order: the same
    weights read in NHWC order give other logits (the layout fault the JAX
    package's transpose before its flatten guards against)."""
    jd = JSG2D(resolution=16, channel_multiplier=1)
    jparams = _perturbed(jd.init(jax.random.key(0)), seed=0)
    d = StyleGAN2Discriminator(16, 1)
    d.load_state_dict(stylegan2_discriminator_from_jax(jparams))
    x = torch.from_numpy(_images(3, 4, 16))
    want = jd.apply(jparams, _nhwc(x.numpy()))
    with torch.no_grad():
        _assert_logits_close(d(x).numpy(), want)
        w = d.final_linear1.weight
        d.final_linear1.weight.copy_(w.reshape(w.shape[0], -1, 4, 4).permute(0, 2, 3, 1)
                                     .reshape(w.shape[0], -1))
        wrong = d(x).numpy()
    assert np.abs(wrong - np.asarray(want)).max() > 1e-2 * np.abs(np.asarray(want)).max()


def test_stylegan2_d_rejects_a_batch_off_the_stddev_group():
    """B=6 is not a multiple of the group min(B, 4): both packages refuse it."""
    jd = JSG2D(resolution=16, channel_multiplier=1)
    jparams = jd.init(jax.random.key(1))
    d = StyleGAN2Discriminator(16, 1)
    d.load_state_dict(stylegan2_discriminator_from_jax(jparams))
    x = _images(4, 6, 16)
    with pytest.raises(TypeError):
        jd.apply(jparams, _nhwc(x))
    with pytest.raises(ValueError, match="stddev group"):
        d(torch.from_numpy(x))
    # B=3 < 4: one group of three, as in the JAX package.
    with torch.no_grad():
        got = d(torch.from_numpy(x[:3])).numpy()
    _assert_logits_close(got, jd.apply(jparams, _nhwc(x[:3])))


# --------------------------------------------------------------------- BigGAN
BIGGAN_D_CASES = [(128, 16, "64", 1), (64, 16, "16_32", 2), (32, 8, "16", 4)]


@pytest.mark.parametrize("resolution", [32, 64, 128, 256])
def test_biggan_d_arch_tables_match_jax(resolution):
    assert biggan_d_arch(96, resolution, "64") == j_biggan_d_arch(96, resolution, "64")


@pytest.mark.parametrize("resolution,ch,attention,n_attn", BIGGAN_D_CASES)
def test_biggan_d_matches_jax_from_reference_layout(resolution, ch, attention, n_attn):
    sd = fabricate_biggan_d(resolution, ch, attention, N_CLASSES, seed=resolution)
    jd = JBigGAND(resolution=resolution, ch=ch, n_classes=N_CLASSES, attention=attention)
    jparams = biggan_d_params_from_state_dict(sd)
    d = BigGANDiscriminator(resolution, ch, N_CLASSES, attention)
    d.load_state_dict(biggan_d_state_dict_from_reference(sd))
    assert sum(b.attention is not None for b in d.blocks) == n_attn
    x, y = _images(5, 3, resolution), np.array([0, 239, 17])
    with torch.no_grad():
        got = d(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _assert_logits_close(got, jd.apply(jparams, _nhwc(x), jnp.asarray(y)))
    assert got.shape == (3, 1)


@pytest.mark.parametrize("resolution,ch,attention,n_attn", BIGGAN_D_CASES)
def test_biggan_d_matches_jax_through_from_jax(resolution, ch, attention, n_attn):
    jd = JBigGAND(resolution=resolution, ch=ch, n_classes=N_CLASSES, attention=attention)
    jparams = _perturbed(jd.init(jax.random.key(7)), seed=resolution)
    d = BigGANDiscriminator(resolution, ch, N_CLASSES, attention)
    d.load_state_dict(biggan_d_from_jax(jparams))
    x, y = _images(6, 2, resolution), np.array([5, 100])
    with torch.no_grad():
        got = d(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    _assert_logits_close(got, jd.apply(jparams, _nhwc(x), jnp.asarray(y)))


def test_biggan_d_sees_its_attention_and_projection():
    """Closing the attention (gamma 0) or changing the class moves the logits:
    both terms take part in what the comparisons above hold."""
    sd = fabricate_biggan_d(128, 16, "64", N_CLASSES, seed=1)
    d = BigGANDiscriminator(128, 16, N_CLASSES, "64")
    d.load_state_dict(biggan_d_state_dict_from_reference(sd))
    x, y = torch.from_numpy(_images(7, 2, 128)), torch.tensor([3, 4])
    with torch.no_grad():
        base = d(x, y)
        other = d(x, torch.tensor([4, 3]))
        d.blocks[0].attention.gamma.zero_()
        closed = d(x, y)
    scale = float(base.abs().max())
    assert float((other - base).abs().max()) > 1e-2 * scale
    assert float((closed - base).abs().max()) > 1e-2 * scale


@pytest.fixture(scope="module")
def gd_pair():
    """(JAX G_D, its G and D params, port G_D) at BigGAN-128's tables, ch=16."""
    jgen, jgparams, gen = small_biggans(128, 16, "64", seed=3, target_classes=(239,))
    sd = fabricate_biggan_d(128, 16, "64", N_CLASSES, seed=4)
    jd = JBigGAND(resolution=128, ch=16, n_classes=N_CLASSES, attention="64")
    d = BigGANDiscriminator(128, 16, N_CLASSES, "64")
    d.load_state_dict(biggan_d_state_dict_from_reference(sd))
    return JGD(jgen, jd), jgparams, biggan_d_params_from_state_dict(sd), BigGAN_GD(gen, d.eval())


@pytest.mark.parametrize("real,split_D", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_biggan_gd_matches_jax(gd_pair, real, split_D):
    """G then D, with and without real images, as one D forward over the
    concatenation or one each, at D's gate. The fake logits read G's image,
    which the JAX package computes in another exact formulation (its merged
    upsampling conv), yet they too stay within it."""
    jgd, jgp, jdp, gd = gd_pair
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 120)).astype(np.float32)
    gy = np.array([239, 239])
    x = _images(9, 2, 128) if real else None
    dy = np.array([14, 239]) if real else None
    want = jgd.apply(jgp, jdp, jnp.asarray(z), jnp.asarray(gy),
                     x=None if x is None else _nhwc(x),
                     dy=None if dy is None else jnp.asarray(dy), split_D=split_D)
    with torch.no_grad():
        got = gd(torch.from_numpy(z), torch.from_numpy(gy),
                 x=None if x is None else torch.from_numpy(x),
                 dy=None if dy is None else torch.from_numpy(dy), split_D=split_D)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if real else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 1)
        _assert_logits_close(g.numpy(), w)
