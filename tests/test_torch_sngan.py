"""The port's SNGAN generator against the JAX package's, on the CPU.

One reference-layout SNGAN ``GenWrapper`` ``state_dict`` is fabricated with
numpy (no SNGAN checkpoint is in the repository), with stored BatchNorm
statistics and biases away from their initial values, and loaded into the
JAX package by ``sngan_params_from_state_dict`` and into the port by
``convert/sngan.py``; the JAX package's parameters also reach the port
through ``convert/from_jax.py::sngan_from_jax``. Both configurations run at
full width: the same z and shift go through both generators. The gates: f32
within 1e-5, bf16 above 40 dB PSNR, as the repo holds whole generators.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.convert.torch_import import sngan_params_from_state_dict
from warpedganspace_tpu.models.sngan import SNGAN_CONFIGS as J_CONFIGS
from warpedganspace_tpu.models.sngan import SNGANGenerator as JGenerator
from warpedganspace_torch.convert.from_jax import sngan_from_jax
from warpedganspace_torch.convert.sngan import load_reference_state_dict
from warpedganspace_torch.models.api import GeneratorBundle, cast_params_bf16
from warpedganspace_torch.models.sngan import SNGAN_CONFIGS, SNGANGenerator

torch.set_num_threads(1)

GAN_TYPES = ("SNGAN_MNIST", "SNGAN_AnimeFaces")


def fabricate_sngan_sd(channels, image_channels, seed=0, dim_z=128):
    """A reference-layout SNGAN ``state_dict`` as numpy arrays: unit-gain
    convs, non-zero biases and BatchNorm statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(prefix, cin, cout, k=3, gain=1.0):
        std = gain / math.sqrt(cin * k * k)
        sd[prefix + ".weight"] = (std * rng.standard_normal((cout, cin, k, k))).astype(np.float32)
        sd[prefix + ".bias"] = (0.05 * rng.standard_normal(cout)).astype(np.float32)

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[prefix + ".bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[prefix + ".running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[prefix + ".running_var"] = rng.uniform(0.6, 1.5, c).astype(np.float32)
        sd[prefix + ".num_batches_tracked"] = np.asarray(7, dtype=np.int64)

    n = len(channels) - 1
    sd["model.0.weight"] = (rng.standard_normal((channels[0] * 16, dim_z)) / math.sqrt(dim_z)
                            ).astype(np.float32)
    sd["model.0.bias"] = (0.05 * rng.standard_normal(channels[0] * 16)).astype(np.float32)
    for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
        pre = f"model.{2 + i}"
        bn(pre + ".model.0", cin)
        conv(pre + ".conv1", cin, cout, gain=math.sqrt(2.0))
        bn(pre + ".model.4", cout)
        conv(pre + ".conv2", cout, cout, gain=math.sqrt(2.0))
        if cin != cout:
            conv(pre + ".bypass.1", cin, cout)
    bn(f"model.{2 + n}", channels[-1])
    conv(f"model.{2 + n + 2}", channels[-1], image_channels)
    return sd


def small_sngans(channels=(32, 32, 16, 16), img_size=32, image_channels=1, seed=0):
    """(JAX generator, JAX params, port generator) carrying one fabricated
    checkpoint of a narrow chain (the training and CLI tests' generator)."""
    sd = fabricate_sngan_sd(channels, image_channels, seed)
    jgen = JGenerator(channels=tuple(channels), img_size=img_size,
                      image_channels=image_channels)
    jparams = sngan_params_from_state_dict(sd, tuple(channels))
    gen = SNGANGenerator(channels, img_size, image_channels)
    load_reference_state_dict(gen, sd).requires_grad_(False).eval()
    return jgen, jparams, gen


def small_sngan_bundles(seed=0):
    """A small SNGAN-MNIST-shaped generator behind the contract of both packages."""
    from warpedganspace_tpu.models.api import GeneratorBundle as JBundle

    jgen, jparams, gen = small_sngans(seed=seed)
    jG = JBundle(name="SNGAN_MNIST", dim_z=128, resolution=32, out_channels=1,
                 params=jparams, apply_fn=jgen.apply)
    return jG, GeneratorBundle("SNGAN_MNIST", gen, dim_z=128, resolution=32)


def _latents(seed, b=3, d=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            (0.2 * rng.standard_normal((b, d))).astype(np.float32))


def _psnr(img, ref):
    peak = float(ref.max() - ref.min())
    return 10 * math.log10(peak ** 2 / float(np.mean((img - ref) ** 2)))


@pytest.fixture(scope="module", params=GAN_TYPES)
def full_width(request):
    """One fabricated checkpoint at the configuration's full width, in both packages."""
    gan_type = request.param
    cfg = SNGAN_CONFIGS[gan_type]
    assert J_CONFIGS[gan_type]["channels"] == cfg["channels"]
    sd = fabricate_sngan_sd(cfg["channels"], cfg["image_channels"], seed=3)
    jgen = JGenerator.from_gan_type(gan_type)
    jparams = sngan_params_from_state_dict(sd, jgen.channels)
    z, shift = _latents(4)
    ref = np.asarray(jgen.apply(jparams, jnp.asarray(z), jnp.asarray(shift))).transpose(0, 3, 1, 2)
    return gan_type, sd, jparams, z, shift, ref


def test_generator_matches_jax(full_width):
    gan_type, sd, jparams, z, shift, ref = full_width
    cfg = SNGAN_CONFIGS[gan_type]
    via_sd = load_reference_state_dict(SNGANGenerator.from_gan_type(gan_type), sd).eval()
    via_jax = SNGANGenerator.from_gan_type(gan_type).eval()
    via_jax.load_state_dict(sngan_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    for (name, a), (_, b) in zip(via_sd.state_dict().items(), via_jax.state_dict().items()):
        assert torch.equal(a, b), name
    with torch.no_grad():
        img = via_sd(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
    assert img.shape == ref.shape == (3, cfg["image_channels"], cfg["img_size"], cfg["img_size"])
    # f32 through four or five residual blocks; sums in another order.
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)
    assert float(np.std(img)) > 0.05                 # not a saturated or constant image


def test_bf16_against_f32(full_width):
    gan_type, sd, _, z, shift, ref = full_width
    gen16 = cast_params_bf16(
        load_reference_state_dict(SNGANGenerator.from_gan_type(gan_type), sd).eval())
    assert all(p.dtype == torch.bfloat16 for p in gen16.parameters())
    with torch.no_grad():
        img = gen16(torch.from_numpy(z).bfloat16(), torch.from_numpy(shift).bfloat16())
    assert img.dtype == torch.bfloat16
    assert _psnr(img.float().numpy(), ref) > 40.0


def test_shift_gradient_matches_jax():
    """Training differentiates the frozen generator with respect to the shift."""
    jgen, jparams, gen = small_sngans(seed=5)
    z, shift = _latents(6, b=2)
    w = np.random.default_rng(7).standard_normal((2, 1, 32, 32)).astype(np.float32)

    jgrad = jax.grad(lambda s: jnp.sum(jgen.apply(jparams, jnp.asarray(z), s)
                                       * jnp.asarray(w.transpose(0, 2, 3, 1))))(
        jnp.asarray(shift))
    s = torch.from_numpy(shift).requires_grad_(True)
    torch.sum(gen(torch.from_numpy(z), s) * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5)
    assert not any(p.requires_grad for p in gen.parameters())


def test_build_gan_sngan(tmp_path):
    """``build_gan`` reads the reference layout from the registry's path and
    builds seeded random weights when allowed and the file is missing."""
    from warpedganspace_torch.config import GAN_WEIGHTS
    from warpedganspace_torch.models.gan_load import build_gan

    G1, G2 = (build_gan("SNGAN_AnimeFaces", weights_root=str(tmp_path), allow_random_init=True,
                        device="cpu") for _ in range(2))
    assert (G1.name, G1.dim_z, G1.resolution) == ("SNGAN_AnimeFaces", 128, 64)
    for (name, a), (_, b) in zip(G1.state_dict().items(), G2.state_dict().items()):
        assert torch.equal(a, b), name
    assert not any(p.requires_grad for p in G1.parameters())
    with pytest.raises(FileNotFoundError):
        build_gan("SNGAN_MNIST", weights_root=str(tmp_path), allow_random_init=False)

    cfg = SNGAN_CONFIGS["SNGAN_MNIST"]
    sd = fabricate_sngan_sd(cfg["channels"], cfg["image_channels"], seed=9)
    path = tmp_path / GAN_WEIGHTS["SNGAN_MNIST"]["weights"][32]
    os.makedirs(path.parent)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    G = build_gan("SNGAN_MNIST", weights_root=str(tmp_path), device="cpu")
    jgen = JGenerator.from_gan_type("SNGAN_MNIST")
    z, shift = _latents(10, b=2)
    ref = np.asarray(jgen.apply(sngan_params_from_state_dict(sd, jgen.channels),
                                jnp.asarray(z), jnp.asarray(shift))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        img = G(torch.from_numpy(z), torch.from_numpy(shift)).numpy()   # the bundle's call
    assert img.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)


def test_random_init_and_chain_rules():
    a, b = (SNGANGenerator.from_gan_type("SNGAN_MNIST", generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    # xavier-uniform bound of the blocks' convs (gain sqrt 2): sqrt(6 / (2 * 9 * 256)) * sqrt 2
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (9 * 256 + 9 * 256))
    w = a.blocks[0].conv1.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert all(blk.bypass is None for blk in a.blocks)                  # (256,)*4: no bypass
    anime = SNGANGenerator.from_gan_type("SNGAN_AnimeFaces")
    assert all(blk.bypass is not None for blk in anime.blocks)           # every block halves
    with pytest.raises(ValueError, match="render"):
        SNGANGenerator((64, 32), img_size=32, image_channels=1)
