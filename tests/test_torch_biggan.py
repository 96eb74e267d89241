"""The port's BigGAN generator against the JAX package's, on the CPU.

One reference-layout ``G_ema`` ``state_dict`` is fabricated with numpy (the
checkpoint itself is not in the repository), loaded into the JAX package by
``biggan_params_from_state_dict`` and into the port by ``convert/biggan.py``;
both fold the spectral norm. The same z, shift and classes then go through
both generators. The gate is the one ``tests/test_biggan.py`` holds the JAX
model to against the reference: PSNR > 40 dB and allclose(5e-2, 5e-3).
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.convert.biggan import biggan_params_from_state_dict
from warpedganspace_tpu.models.api import cast_params_bf16 as j_cast_params_bf16
from warpedganspace_tpu.models.biggan import BigGANGenerator as JGenerator
from warpedganspace_tpu.models.biggan import biggan_arch as j_biggan_arch
from warpedganspace_torch.convert.biggan import load_reference_state_dict
from warpedganspace_torch.convert.from_jax import biggan_from_jax
from warpedganspace_torch.models.api import cast_params_bf16
from warpedganspace_torch.models.biggan import BigGANGenerator, biggan_arch

torch.set_num_threads(1)

SHARED_DIM, N_CLASSES = 16, 240


def fabricate_g_ema(resolution, ch, attention, seed=0, dim_z=120):
    """A reference-layout BigGAN ``G_ema`` ``state_dict`` as numpy arrays, with
    non-trivial SN ``u0`` vectors, stored BN statistics and attention gammas."""
    rng = np.random.default_rng(seed)
    arch = j_biggan_arch(ch, resolution, attention)
    chunk = dim_z // (len(arch["in_channels"]) + 1)
    cond = SHARED_DIM + chunk
    sd = {}

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    def sn(prefix, shape, bias=True):
        fan_in = int(np.prod(shape[1:]))
        sd[prefix + ".weight"] = f32(rng.standard_normal(shape) * (1.5 / math.sqrt(fan_in)))
        sd[prefix + ".u0"] = f32(rng.standard_normal((1, shape[0])))
        if bias:
            sd[prefix + ".bias"] = f32(0.1 * rng.standard_normal(shape[0]))

    def ccbn(prefix, c):
        sn(prefix + ".gain", (c, cond), bias=False)
        sn(prefix + ".bias", (c, cond), bias=False)
        sd[prefix + ".stored_mean"] = f32(0.1 * rng.standard_normal(c))
        sd[prefix + ".stored_var"] = f32(rng.uniform(0.6, 1.5, c))

    sd["shared.weight"] = f32(rng.standard_normal((N_CLASSES, SHARED_DIM)))
    sn("linear", (arch["in_channels"][0] * 16, chunk))
    for i, (cin, cout) in enumerate(zip(arch["in_channels"], arch["out_channels"])):
        pre = f"blocks.{i}.0."
        ccbn(pre + "bn1", cin)
        sn(pre + "conv1", (cout, cin, 3, 3))
        ccbn(pre + "bn2", cout)
        sn(pre + "conv2", (cout, cout, 3, 3))
        sn(pre + "conv_sc", (cout, cin, 1, 1))
        if arch["attention"][i]:
            apre = f"blocks.{i}.1."
            sn(apre + "theta", (cout // 8, cout, 1, 1), bias=False)
            sn(apre + "phi", (cout // 8, cout, 1, 1), bias=False)
            sn(apre + "g", (cout // 2, cout, 1, 1), bias=False)
            sn(apre + "o", (cout, cout // 2, 1, 1), bias=False)
            sd[apre + "gamma"] = f32(0.7 + 0.1 * i)
    c = arch["out_channels"][-1]
    sd["output_layer.0.gain"] = f32(rng.uniform(0.8, 1.2, c))
    sd["output_layer.0.bias"] = f32(0.1 * rng.standard_normal(c))
    sd["output_layer.0.stored_mean"] = f32(0.1 * rng.standard_normal(c))
    sd["output_layer.0.stored_var"] = f32(rng.uniform(0.6, 1.5, c))
    sn("output_layer.2", (3, c, 3, 3))
    return sd


def small_biggans(resolution=32, ch=16, attention="32", seed=0, target_classes=(3,)):
    """(JAX generator, JAX params, port generator) carrying one fabricated checkpoint."""
    sd = fabricate_g_ema(resolution, ch, attention, seed)
    jgen = JGenerator(resolution=resolution, ch=ch, dim_z=120, shared_dim=SHARED_DIM,
                      n_classes=N_CLASSES, attention=attention,
                      target_classes=tuple(target_classes))
    jparams = biggan_params_from_state_dict(sd)
    gen = BigGANGenerator(resolution=resolution, ch=ch, dim_z=120, shared_dim=SHARED_DIM,
                          n_classes=N_CLASSES, attention=attention,
                          target_classes=target_classes)
    load_reference_state_dict(gen, sd)
    return jgen, jparams, gen.requires_grad_(False).eval()


def _psnr(img, ref):
    peak = float(ref.max() - ref.min())
    return 10 * math.log10(peak ** 2 / float(np.mean((img - ref) ** 2)))


def _latents(seed, b, dim):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, dim)).astype(np.float32),
            (0.1 * rng.standard_normal((b, dim))).astype(np.float32))


def _jax_image(jgen, jparams, z, shift, y):
    img = jgen.apply(jparams, jnp.asarray(z), None if shift is None else jnp.asarray(shift),
                     y=None if y is None else jnp.asarray(y))
    return np.asarray(img.astype(jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("resolution,ch,attention,n_attn", [
    (32, 16, "32", 1),
    (64, 16, "32_64", 2),
    (128, 16, "64", 1),
])
def test_forward_matches_jax_from_g_ema(resolution, ch, attention, n_attn):
    jgen, jparams, gen = small_biggans(resolution, ch, attention)
    assert sum(b.attention is not None for b in gen.blocks) == n_attn
    assert sum("attention" in b for b in jparams["blocks"]) == n_attn
    z, shift = _latents(1, 2, 120)
    y = np.array([3, 7])
    ref = _jax_image(jgen, jparams, z, shift, y)
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z), torch.from_numpy(shift),
                        y=torch.from_numpy(y)).numpy()
    assert img.shape == ref.shape == (2, 3, resolution, resolution)
    assert ref.std() > 0.05                          # a real image, not a constant
    assert _psnr(img, ref) > 40.0
    np.testing.assert_allclose(img, ref, rtol=5e-2, atol=5e-3)


def test_forward_matches_jax_through_biggan_from_jax():
    """``biggan_from_jax`` carries the JAX pytree (converted checkpoint, and the
    package's own random init, whose convs have biases and gamma 0) across."""
    jgen, jparams, _ = small_biggans(64, 16, "32_64", seed=2)
    z, shift = _latents(3, 2, 120)
    y = np.array([0, 239])
    for params in (jparams, jgen.init(jax.random.key(5))):
        gen = BigGANGenerator(resolution=64, ch=16, shared_dim=SHARED_DIM,
                              n_classes=N_CLASSES, attention="32_64")
        gen.load_state_dict(biggan_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        ref = _jax_image(jgen, params, z, shift, y)
        with torch.no_grad():
            img = gen.eval().apply(torch.from_numpy(z), torch.from_numpy(shift),
                                   y=torch.from_numpy(y)).numpy()
        assert _psnr(img, ref) > 40.0
        np.testing.assert_allclose(img, ref, rtol=5e-2, atol=5e-3)


def test_z_of_length_120_at_256():
    """7 slots at 256^2: dim_z shrinks to 119 and the last element of a
    120-long z is unused, as in the reference's narrow()."""
    jgen, jparams, gen = small_biggans(256, 8, "64")
    assert gen.num_slots == jgen.num_slots == 7
    assert gen.z_chunk_size == jgen.z_chunk_size == 17
    assert gen.dim_z_effective == jgen.dim_z_effective == 119
    z, _ = _latents(4, 1, 120)
    y = np.array([5])
    ref = _jax_image(jgen, jparams, z, None, y)
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z), y=torch.from_numpy(y)).numpy()
        img119 = gen.apply(torch.from_numpy(z[:, :119]), y=torch.from_numpy(y)).numpy()
    assert img.shape == (1, 3, 256, 256)
    assert _psnr(img, ref) > 40.0
    np.testing.assert_array_equal(img, img119)


@pytest.mark.parametrize("resolution", [32, 64, 128, 256, 512])
def test_arch_tables_match_jax(resolution):
    assert biggan_arch(96, resolution, "32_64") == j_biggan_arch(96, resolution, "32_64")


def test_from_config_matches_jax():
    jgen = JGenerator.from_config(target_classes=(239,))
    from warpedganspace_torch.models import biggan as t_biggan

    with open(t_biggan.CONFIG_FILE) as f:
        config = json.load(f)
    small = dict(config, G_ch=8)                     # full width is too big to build here
    gen = BigGANGenerator.from_config(small, target_classes=[239])
    jsmall = JGenerator.from_config(small, target_classes=[239])
    for name in ("resolution", "ch", "dim_z", "shared_dim", "n_classes", "bottom_width",
                 "target_classes", "attention"):
        assert getattr(gen, name) == getattr(jsmall, name), name
    # The port's copy of the shipped config is the JAX package's.
    for name in ("resolution", "dim_z", "shared_dim", "n_classes", "attention"):
        assert getattr(jgen, name) == getattr(jsmall, name), name
    assert (config["G_ch"], jgen.ch) == (96, 96)


def test_mixed_classes():
    jgen, _, gen = small_biggans(32, 16, "32", target_classes=(3,))
    z, _ = _latents(5, 4, 120)
    one = gen.mixed_classes(torch.from_numpy(z))
    np.testing.assert_array_equal(one.numpy(), np.asarray(jgen.mixed_classes(jnp.asarray(z))))
    y = torch.tensor([1, 2, 3, 4])
    assert gen.mixed_classes(torch.from_numpy(z), y) is y
    # Several classes: drawn from the targets, and the same z gives the same draw.
    gen.target_classes = (3, 7, 11)
    a = gen.mixed_classes(torch.from_numpy(z))
    b = gen.mixed_classes(torch.from_numpy(z.copy()))
    assert torch.equal(a, b) and set(a.tolist()) <= {3, 7, 11}
    draws = {tuple(gen.mixed_classes(torch.from_numpy(_latents(s, 4, 120)[0])).tolist())
             for s in range(8)}
    assert len(draws) > 1                            # it does depend on z


def test_bf16_render_matches_jax_bf16():
    jgen, jparams, gen = small_biggans(64, 16, "32_64", seed=6)
    z, shift = _latents(7, 2, 120)
    y = np.array([3, 3])
    ref = _jax_image(jgen, j_cast_params_bf16(jparams), z.astype(jnp.bfloat16),
                     shift.astype(jnp.bfloat16), y)
    gen16 = cast_params_bf16(gen)
    assert all(t.dtype == torch.bfloat16 for t in gen16.state_dict().values())
    assert gen16.blocks[0].bn1.mean.dtype == torch.bfloat16      # ccbn statistics too
    with torch.no_grad():
        img = gen16.apply(torch.from_numpy(z).bfloat16(), torch.from_numpy(shift).bfloat16(),
                          y=torch.from_numpy(y))
    assert img.dtype == torch.bfloat16
    # bf16 rounds at other places in the two frameworks; the f32 cases carry
    # the algorithm.
    assert _psnr(img.float().numpy(), ref) > 30.0


def test_build_gan_biggan(tmp_path, monkeypatch):
    """``build_gan('BigGAN')`` reads the port's config and a ``G_ema.pth`` in
    the reference layout; without the file it raises unless random weights
    are allowed."""
    from warpedganspace_torch.config import GAN_WEIGHTS
    from warpedganspace_torch.models import biggan as t_biggan
    from warpedganspace_torch.models.gan_load import build_gan

    with open(t_biggan.CONFIG_FILE) as f:
        config = json.load(f)
    small = tmp_path / "small_config.json"
    small.write_text(json.dumps(dict(config, G_ch=8, dataset="I32", shared_dim=SHARED_DIM,
                                     G_attn="32")))
    monkeypatch.setattr(t_biggan, "CONFIG_FILE", str(small))
    monkeypatch.setattr(t_biggan, "NCLASS_DICT", dict(t_biggan.NCLASS_DICT, I32=N_CLASSES))

    with pytest.raises(FileNotFoundError):
        build_gan("BigGAN", target_classes=[3], weights_root=str(tmp_path),
                  allow_random_init=False)
    G1, G2 = (build_gan("BigGAN", target_classes=[3], weights_root=str(tmp_path),
                        allow_random_init=True, device="cpu") for _ in range(2))
    assert (G1.name, G1.dim_z, G1.resolution, G1.shift_in_w_space) == ("BigGAN", 120, 32, False)
    for (name, a), (_, b) in zip(G1.state_dict().items(), G2.state_dict().items()):
        assert torch.equal(a, b), name               # random weights from a seed
    assert not any(p.requires_grad for p in G1.parameters())

    sd = fabricate_g_ema(32, 8, "32", seed=8)
    path = tmp_path / GAN_WEIGHTS["BigGAN"]["weights"][128]
    os.makedirs(path.parent)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    G = build_gan("BigGAN", target_classes=[3], weights_root=str(tmp_path), device="cpu")
    jgen = JGenerator(resolution=32, ch=8, shared_dim=SHARED_DIM, n_classes=N_CLASSES,
                      attention="32", target_classes=(3,))
    z, shift = _latents(9, 2, 120)
    ref = _jax_image(jgen, biggan_params_from_state_dict(sd), z, shift, None)
    with torch.no_grad():
        img = G(torch.from_numpy(z), torch.from_numpy(shift)).numpy()   # the bundle's call
    assert _psnr(img, ref) > 40.0
    assert torch.equal(G.get_w(torch.from_numpy(z)), torch.from_numpy(z))
