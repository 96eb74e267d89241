"""The port's ProgGAN generator against the JAX package's, on the CPU.

One reference-layout ProgGAN ``state_dict`` is fabricated with numpy (the
CelebA-HQ checkpoint itself is not in the repository) on the tiny chain of
``tests/test_proggan_pallas.py``, loaded into the JAX package by
``proggan_params_from_state_dict`` and into the port by
``convert/proggan.py``. The same z and shift then go through both generators.
The JAX side runs its plain NHWC composition (``tail_layout="nhwc"``) and its
fused tail kernel in interpret mode (``"pallas"``); the port runs the plain
versions (a CPU tensor). The gate is the repo's for whole generators:
PSNR > 40 dB, and allclose with the stated bound.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.convert.torch_import import proggan_params_from_state_dict
from warpedganspace_tpu.models.api import cast_params_bf16 as j_cast_params_bf16
from warpedganspace_tpu.models.proggan import ProgGANGenerator as JGenerator
from warpedganspace_torch.convert.from_jax import proggan_from_jax
from warpedganspace_torch.convert.proggan import load_reference_state_dict
from warpedganspace_torch.models.api import cast_params_bf16
from warpedganspace_torch.models.proggan import ProgGANGenerator
from warpedganspace_torch.ops import proggan_tail_cuda

torch.set_num_threads(1)

# Entry of the fused tail at block 4 (up 128 -> 64), then (64, 64), (32, 32),
# (16, 16) and the head; 64^2 output.
TINY_CH = [128, 128, 128, 128, 128, 64, 64, 32, 32, 16, 16]
KERNELS = [4, 3] + [3] * 16


def fabricate_proggan_sd(channels=TINY_CH, seed=0):
    """A reference-layout ProgGAN ``state_dict`` as numpy arrays: unit-gain
    weights, WScale scales != 1 and non-zero biases (the package's random init
    has scale 1 and bias 0, which would hide a wrong WScale)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def entry(prefix, cin, cout, k):
        std = 1.0 / math.sqrt(cin * k * k)
        sd[prefix + ".conv.weight"] = (std * rng.standard_normal((cout, cin, k, k))
                                       ).astype(np.float32)
        sd[prefix + ".wscale.scale"] = rng.uniform(0.7, 1.4, (1,)).astype(np.float32)
        sd[prefix + ".wscale.b"] = (0.2 * rng.standard_normal(cout)).astype(np.float32)

    for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
        entry(f"features.{i}", cin, cout, KERNELS[i])
    entry("output", channels[-1], 3, 1)
    return sd


def small_proggans(channels=TINY_CH, seed=0):
    """(JAX params, port generator) carrying one fabricated checkpoint."""
    sd = fabricate_proggan_sd(channels, seed)
    gen = ProgGANGenerator(dim_z=channels[0], channels=channels)
    load_reference_state_dict(gen, sd)
    return proggan_params_from_state_dict(sd), gen.requires_grad_(False).eval()


def _psnr(img, ref):
    peak = float(ref.max() - ref.min())
    return 10 * math.log10(peak ** 2 / float(np.mean((img - ref) ** 2)))


def _latents(seed, b, dim):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, dim)).astype(np.float32),
            (0.1 * rng.standard_normal((b, dim))).astype(np.float32))


def _jax_image(jparams, z, shift, tail_layout, dim_z=128):
    jgen = JGenerator(dim_z=dim_z, tail_layout=tail_layout)
    with jax.default_matmul_precision("highest"):
        img = jgen.apply(jparams, jnp.asarray(z), None if shift is None else jnp.asarray(shift))
    return np.asarray(img.astype(jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("tail_layout", ["nhwc", "pallas"])
def test_forward_matches_jax_from_reference_sd(tail_layout):
    jparams, gen = small_proggans()
    assert gen.resolution == 64 and gen.tail_split()[0] == 4
    z, shift = _latents(1, 2, 128)
    ref = _jax_image(jparams, z, shift, tail_layout)
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
    assert img.shape == ref.shape == (2, 3, 64, 64)
    assert ref.std() > 0.05                          # a real image, not a constant
    assert _psnr(img, ref) > 40.0
    # Eleven f32 convolutions deep, each renormalised by the next PixelNorm:
    # the bound tests/test_proggan_pallas.py holds pallas to nhwc with, doubled.
    np.testing.assert_allclose(img, ref, rtol=6e-5, atol=6e-5)


def test_no_shift_and_bundle_contract():
    from warpedganspace_torch.models.api import GeneratorBundle

    jparams, gen = small_proggans(seed=2)
    z, shift = _latents(3, 2, 128)
    G = GeneratorBundle("ProgGAN", gen, dim_z=128, resolution=64)
    with torch.no_grad():
        img = G(torch.from_numpy(z)).numpy()
        shifted = G(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
        summed = G(torch.from_numpy(z + shift), latent_is_w=True).numpy()   # flag ignored
    assert _psnr(img, _jax_image(jparams, z, None, "nhwc")) > 40.0
    np.testing.assert_array_equal(shifted, summed)
    assert torch.equal(G.get_w(torch.from_numpy(z)), torch.from_numpy(z))


def test_forward_matches_jax_through_proggan_from_jax():
    """``proggan_from_jax`` carries the JAX pytree across: the converted
    checkpoint, and the package's own random init (scale 1, bias 0)."""
    jparams, gen0 = small_proggans(seed=4)
    z, shift = _latents(5, 2, 128)
    init = JGenerator(dim_z=128).init(jax.random.key(6), channels=TINY_CH)
    for params in (jparams, init):
        gen = ProgGANGenerator(dim_z=128, channels=TINY_CH)
        gen.load_state_dict(proggan_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        ref = _jax_image(params, z, shift, "nhwc")
        with torch.no_grad():
            img = gen.eval().apply(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
        assert _psnr(img, ref) > 40.0
        np.testing.assert_allclose(img, ref, rtol=6e-5, atol=6e-5)
    # The round trip reference layout -> JAX pytree -> port is the direct load.
    back = proggan_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, t in gen0.state_dict().items():
        assert torch.equal(back[name], t), name


def test_first_block_is_the_4x4_seed():
    """Block 0 pads the 1x1 latent map by 3, so its 4x4 conv gives a 4x4 map:
    output pixel (y, x) reads weight tap (3 - y, 3 - x)."""
    jparams, gen = small_proggans([16, 8], seed=7)
    assert gen.resolution == 4 and len(gen.blocks) == 1 and gen.tail_split() == (1, [])
    z, _ = _latents(8, 3, 16)
    ref = _jax_image(jparams, z, None, "nhwc", dim_z=16)
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z)).numpy()
    assert img.shape == ref.shape == (3, 3, 4, 4)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)
    # By hand: PixelNorm z, one tap per output pixel, WScale, LeakyReLU, head.
    block, out = gen.blocks[0], gen.out
    zt = torch.from_numpy(z)
    zn = zt * torch.rsqrt((zt * zt).mean(1, keepdim=True) + 1e-8)
    h = torch.einsum("bi,oiyx->boyx", zn, block.weight.flip(2, 3)) * block.scale
    h = torch.nn.functional.leaky_relu(h + block.bias[None, :, None, None], 0.2)
    h = h * torch.rsqrt((h * h).mean(1, keepdim=True) + 1e-8)
    hand = torch.einsum("bcyx,oc->boyx", h, out.weight[:, :, 0, 0]) * out.scale
    hand = hand + out.bias[None, :, None, None]
    np.testing.assert_allclose(img, hand.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_nonmatching_chain_runs_plain(monkeypatch):
    """A chain without a fusable suffix never reaches the tail wrapper, as the
    JAX package routes it to its nhwc composition."""
    ch = [512, 256, 256, 128, 128]
    jparams, gen = small_proggans(ch, seed=9)
    assert gen.tail_split() == (4, [])

    def no_tail(*args, **kwargs):
        raise AssertionError("the tail wrapper was called")

    from warpedganspace_torch.models import proggan as t_proggan
    monkeypatch.setattr(t_proggan, "proggan_tail", no_tail)
    z, shift = _latents(10, 2, 512)
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
    for layout in ("nhwc", "pallas"):
        ref = _jax_image(jparams, z, shift, layout, dim_z=512)
        assert img.shape == ref.shape == (2, 3, 8, 8)
        np.testing.assert_allclose(img, ref, rtol=6e-5, atol=6e-5)


def test_matching_chain_goes_through_the_tail_wrapper(monkeypatch):
    """The tiny chain hands its last six blocks and the head to the wrapper,
    with the entry block's 128-channel input; on the CPU that launches nothing."""
    from warpedganspace_torch.models import proggan as t_proggan

    _, gen = small_proggans(seed=11)
    seen = []

    def spy(x, sections, out):
        seen.append((tuple(x.shape), [up.weight.shape[0] for up, _ in sections], out))
        return proggan_tail_cuda.proggan_tail(x, sections, out)

    monkeypatch.setattr(t_proggan, "proggan_tail", spy)
    before = proggan_tail_cuda.launches
    z, _ = _latents(12, 2, 128)
    with torch.no_grad():
        gen.apply(torch.from_numpy(z))
    assert seen == [((2, 128, 8, 8), [64, 32, 16], gen.out)]
    assert proggan_tail_cuda.launches == before


def test_bf16_render_against_f32():
    """``cast_params_bf16`` gives a bf16 copy whose render stays close to the
    f32 one, in the port as in the JAX package."""
    jparams, gen = small_proggans(seed=13)
    z, shift = _latents(14, 2, 128)
    gen16 = cast_params_bf16(gen)
    assert all(t.dtype == torch.bfloat16 for t in gen16.state_dict().values())
    with torch.no_grad():
        img = gen.apply(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
        img16 = gen16.apply(torch.from_numpy(z).bfloat16(), torch.from_numpy(shift).bfloat16())
    assert img16.dtype == torch.bfloat16
    jgen = JGenerator(dim_z=128, tail_layout="nhwc")
    jimg16 = jgen.apply(j_cast_params_bf16(jparams), jnp.asarray(z, jnp.bfloat16),
                        jnp.asarray(shift, jnp.bfloat16))
    jimg16 = np.asarray(jimg16.astype(jnp.float32)).transpose(0, 3, 1, 2)
    # bf16 rounds at other places in the two frameworks; the f32 cases carry
    # the algorithm. Eleven blocks of 8-bit mantissas give about 30 dB.
    assert _psnr(img16.float().numpy(), img) > 25.0
    assert _psnr(jimg16, img) > 25.0
    assert _psnr(img16.float().numpy(), jimg16) > 25.0


def test_seeded_random_init_is_reproducible():
    a, b, c = (ProgGANGenerator(dim_z=128, channels=TINY_CH,
                                generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    for (name, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(ta, tb), name
    assert not torch.equal(a.blocks[0].weight, c.blocks[0].weight)
    # N(0, 0.02) weights, scale 1, bias 0, as the JAX package's init.
    assert abs(float(a.blocks[1].weight.detach().std()) - 0.02) < 1e-3
    assert float(a.blocks[3].scale.detach()) == 1.0 and not a.out.bias.any()
    with pytest.raises(ValueError, match="dim_z"):
        ProgGANGenerator(dim_z=512, channels=TINY_CH)
    with pytest.raises(ValueError, match="renders 64"):
        ProgGANGenerator(dim_z=128, channels=TINY_CH, resolution=1024)


def test_full_width_chain_shapes():
    """The reference 1024^2 chain, built without memory: 18 blocks, 12 of them
    before the fused tail, 23 M parameters."""
    with torch.device("meta"):
        gen = ProgGANGenerator()
    assert (gen.dim_z, gen.resolution, len(gen.blocks)) == (512, 1024, 18)
    n_head, sections = gen.tail_split()
    assert n_head == 12 and [up.weight.shape[0] for up, _ in sections] == [64, 32, 16]
    assert tuple(gen.blocks[0].weight.shape) == (512, 512, 4, 4)
    assert tuple(gen.out.weight.shape) == (3, 16, 1, 1)
    jshapes = jax.eval_shape(lambda k: JGenerator().init(k), jax.random.key(0))
    assert sum(p.numel() for p in gen.parameters()) == sum(
        math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(jshapes))
