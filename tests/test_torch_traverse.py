"""The port's traversal engine and render stream against the JAX package, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from warpedganspace_tpu.models.api import GeneratorBundle as JBundle
from warpedganspace_tpu.models.stylegan2 import StyleGAN2Generator as JGenerator
from warpedganspace_tpu.models.support_sets import SupportSets as JSupportSets
from warpedganspace_tpu.traverse.engine import iter_rendered_u8 as j_iter_rendered_u8
from warpedganspace_tpu.traverse.engine import traverse_paths as j_traverse_paths
from warpedganspace_torch.convert.from_jax import stylegan2_from_jax, support_sets_from_jax
from warpedganspace_torch.models.api import GeneratorBundle
from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.traverse.engine import iter_rendered_u8, traverse_paths

torch.set_num_threads(1)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("leap", [1, 2])
def test_traverse_paths_matches_jax(use_pallas, leap):
    k, n_dip, d = 3, 4, 16
    JS = JSupportSets(k, n_dip, d, learn_gammas=True)
    jparams = JS.init(jax.random.key(0))
    S = SupportSets(k, n_dip, d, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    z = np.random.default_rng(1).standard_normal((2, d)).astype(np.float32)
    jcodes, jshifts = j_traverse_paths(JS, jparams, z, eps=0.2, shift_steps=5,
                                       shift_leap=leap, use_pallas=use_pallas)
    codes, shifts = traverse_paths(S, torch.from_numpy(z), eps=0.2, shift_steps=5,
                                   shift_leap=leap)
    assert codes.shape == jcodes.shape == (2, k, 2 * (5 // leap) + 1, d)
    # f32 over 5 normalised-gradient steps; the bound of the reference oracle.
    np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes), rtol=0, atol=5e-5)
    np.testing.assert_allclose(shifts.numpy(), np.asarray(jshifts), rtol=0, atol=5e-5)
    center = codes.shape[2] // 2
    np.testing.assert_array_equal(codes[:, :, center].numpy(), np.repeat(z[:, None], k, 1))


def small_generators(resolution=32, seed=0):
    """One small W-space StyleGAN2 with the same weights in both packages."""
    jgen = JGenerator(resolution=resolution, n_mlp=2, channel_multiplier=1,
                      shift_in_w_space=True, tail_layout="nhwc")
    jparams = jgen.init(jax.random.key(seed))
    jG = JBundle(name="StyleGAN2", dim_z=512, resolution=resolution, out_channels=3,
                 params=jparams, apply_fn=jgen.apply, get_w_fn=jgen.get_w,
                 shift_in_w_space=True)
    gen = StyleGAN2Generator(resolution=resolution, n_mlp=2, channel_multiplier=1,
                             shift_in_w_space=True)
    gen.load_state_dict(stylegan2_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    G = GeneratorBundle("StyleGAN2", gen.requires_grad_(False).eval(), dim_z=512,
                        resolution=resolution, shift_in_w_space=True)
    return jG, G


def small_biggan_bundles(resolution=32, ch=16, attention="32", seed=0):
    """One small BigGAN (a fabricated ``G_ema`` checkpoint, class 239) behind
    the generator contract of both packages."""
    from tests.test_torch_biggan import small_biggans

    jgen, jparams, gen = small_biggans(resolution, ch, attention, seed, target_classes=(239,))
    jG = JBundle(name="BigGAN", dim_z=120, resolution=resolution, out_channels=3,
                 params=jparams, apply_fn=jgen.apply)
    return jG, GeneratorBundle("BigGAN", gen, dim_z=120, resolution=resolution)


def small_proggan_bundles(seed=0):
    """One small ProgGAN (a fabricated reference-layout checkpoint on the tiny
    chain whose last six blocks form the fused tail, 64^2) behind the generator
    contract of both packages. The JAX side runs its fused tail kernel in
    interpret mode, as its render path does on its accelerator."""
    from tests.test_torch_proggan import TINY_CH, small_proggans
    from warpedganspace_tpu.models.proggan import ProgGANGenerator as JProgGAN

    jparams, gen = small_proggans(TINY_CH, seed)
    jgen = JProgGAN(dim_z=TINY_CH[0], tail_layout="pallas")
    jG = JBundle(name="ProgGAN", dim_z=TINY_CH[0], resolution=64, out_channels=3,
                 params=jparams, apply_fn=jgen.apply)
    return jG, GeneratorBundle("ProgGAN", gen, dim_z=TINY_CH[0], resolution=64)


def test_proggan_traversal_and_render_match_jax():
    """ProgGAN's shape of the engine: warp in Z, frames through the generator
    whose tail is the fused sections."""
    jG, G = small_proggan_bundles()
    k, n_dip, d = 3, 8, 128
    JS = JSupportSets(k, n_dip, d, learn_gammas=True)
    jparams = JS.init(jax.random.key(5))
    S = SupportSets(k, n_dip, d, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    z = np.random.default_rng(6).standard_normal((2, d)).astype(np.float32)
    jcodes, jshifts = j_traverse_paths(JS, jparams, z, eps=0.15, shift_steps=2)
    codes, shifts = traverse_paths(S, torch.from_numpy(z), eps=0.15, shift_steps=2)
    assert codes.shape == jcodes.shape == (2, k, 5, d)
    # f32 over 2 normalised-gradient steps; the bound of the reference oracle.
    np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes), rtol=0, atol=5e-5)

    flat_c = np.array(jcodes)[0].reshape(-1, d)
    flat_s = np.array(jshifts)[0].reshape(-1, d)
    ref = list(j_iter_rendered_u8(jG, jG.params, flat_c, flat_s, batch_size=6))
    got = list(iter_rendered_u8(G, torch.from_numpy(flat_c), torch.from_numpy(flat_s),
                                batch_size=6))
    assert [s for s, _ in got] == [s for s, _ in ref] == [0, 6, 12]
    for (_, a), (_, b) in zip(got, ref):
        assert a.shape == np.asarray(b).shape and a.shape[1:] == (64, 64, 3)
        # One gray level where a float difference straddles a level boundary.
        assert np.max(np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))) <= 1


def test_biggan_traversal_and_render_match_jax():
    """BigGAN's shape of the engine: warp in Z (d=120), frames through the
    class-conditional generator with its attention block."""
    jG, G = small_biggan_bundles()
    k, n_dip, d = 3, 8, 120
    JS = JSupportSets(k, n_dip, d, learn_gammas=True)
    jparams = JS.init(jax.random.key(3))
    S = SupportSets(k, n_dip, d, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    z = np.random.default_rng(4).standard_normal((2, d)).astype(np.float32)
    jcodes, jshifts = j_traverse_paths(JS, jparams, z, eps=0.15, shift_steps=3)
    codes, shifts = traverse_paths(S, torch.from_numpy(z), eps=0.15, shift_steps=3)
    assert codes.shape == jcodes.shape == (2, k, 7, d)
    # f32 over 3 normalised-gradient steps; the bound of the reference oracle.
    np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes), rtol=0, atol=5e-5)

    flat_c = np.array(jcodes)[0].reshape(-1, d)
    flat_s = np.array(jshifts)[0].reshape(-1, d)
    ref = list(j_iter_rendered_u8(jG, jG.params, flat_c, flat_s, batch_size=8))
    got = list(iter_rendered_u8(G, torch.from_numpy(flat_c), torch.from_numpy(flat_s),
                                batch_size=8))
    assert [s for s, _ in got] == [s for s, _ in ref] == [0, 8, 16]
    for (_, a), (_, b) in zip(got, ref):
        assert a.shape == np.asarray(b).shape and a.shape[1:] == (32, 32, 3)
        # One gray level where a float difference straddles a level boundary.
        assert np.max(np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))) <= 1


def test_iter_rendered_u8_matches_jax():
    jG, G = small_generators()
    rng = np.random.default_rng(2)
    codes = rng.standard_normal((7, 512)).astype(np.float32)
    shifts = (0.3 * rng.standard_normal((7, 512))).astype(np.float32)
    ref = list(j_iter_rendered_u8(jG, jG.params, codes, shifts, batch_size=3,
                                  latent_is_w=True))
    got = list(iter_rendered_u8(G, torch.from_numpy(codes), torch.from_numpy(shifts),
                                batch_size=3, latent_is_w=True))
    assert [s for s, _ in got] == [s for s, _ in ref] == [0, 3, 6]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == np.uint8 and a.shape == np.asarray(b).shape
        # Per-image min/max then truncation to uint8: a float difference near
        # a level boundary moves a pixel by one gray level.
        assert np.max(np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))) <= 1
