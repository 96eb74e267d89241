"""The port's StyleGAN2 generator and its ops against the JAX package, on the CPU.

The generator is cut to resolution 64, a 2-layer mapping network and channel
multiplier 1 (the same code paths as 1024: every block type, upsampling,
noise, ToRGB skips). Weights reach the port two ways: the JAX parameters
through ``stylegan2_from_jax``, and a fabricated reference ``g_ema`` state
dict read by both packages' converters. The bound is the repo's generator
gate, PSNR > 40 dB against the JAX image.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.convert.stylegan2 import stylegan2_params_from_state_dict
from warpedganspace_tpu.models.stylegan2 import StyleGAN2Generator as JGenerator
from warpedganspace_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from warpedganspace_tpu.ops.upfirdn2d import upfirdn2d as j_upfirdn2d
from warpedganspace_torch.convert.from_jax import stylegan2_from_jax
from warpedganspace_torch.convert.stylegan2 import load_reference_state_dict
from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator
from warpedganspace_torch.ops.fused_act import fused_leaky_relu
from warpedganspace_torch.ops.upfirdn2d import setup_filter, upfirdn2d

torch.set_num_threads(1)

RES, N_MLP, CM = 64, 2, 1


def psnr(img, ref):
    peak = float(ref.max() - ref.min())
    return 10 * math.log10(peak ** 2 / float(np.mean((img - ref) ** 2)))


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (-1, 2)), (2, 2, (1, -2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 9, 7)).astype(np.float32)   # NCHW
    k = np.asarray(setup_filter((1.0, 3.0, 3.0, 1.0), gain=4.0))
    ref = j_upfirdn2d(x.transpose(0, 2, 3, 1), k, up=up, down=down, pad=pad)
    got = upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    # Short f32 FIR sums.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5)


def test_fused_leaky_relu_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 4, 5)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = j_fused_leaky_relu(x, b, channel_axis=1)
    got = fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b))
    # Elementwise f32.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def fabricate_g_ema(seed: int, resolution: int = RES, n_mlp: int = N_MLP,
                    channel_multiplier: int = CM) -> dict:
    """A reference ``models/StyleGAN2/model.py`` Generator state dict (raw,
    unscaled weights, as the reference stores them) made with numpy."""
    from warpedganspace_tpu.models.stylegan2 import channels_dict

    rng = np.random.default_rng(seed)
    ch = channels_dict(channel_multiplier)
    sd = {}

    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def mod_conv(name, cin, cout, k):
        sd[name + ".conv.weight"] = randn(1, cout, cin, k, k)
        sd[name + ".conv.modulation.weight"] = randn(cin, 512)
        sd[name + ".conv.modulation.bias"] = 1.0 + randn(cin, scale=0.1)

    def styled(name, cin, cout):
        mod_conv(name, cin, cout, 3)
        sd[name + ".noise.weight"] = randn(1, scale=0.1)
        sd[name + ".activate.bias"] = randn(cout, scale=0.1)

    def rgb(name, cin):
        mod_conv(name, cin, 3, 1)
        sd[name + ".bias"] = randn(1, 3, 1, 1, scale=0.1)

    for i in range(n_mlp):
        sd[f"style.{i + 1}.weight"] = randn(512, 512, scale=100.0)   # lr_mul 0.01
        sd[f"style.{i + 1}.bias"] = randn(512)
    sd["input.input"] = randn(1, ch[4], 4, 4)
    styled("conv1", ch[4], ch[4])
    rgb("to_rgb1", ch[4])
    log_size = int(math.log2(resolution))
    cin = ch[4]
    for j, i in enumerate(range(3, log_size + 1)):
        cout = ch[2 ** i]
        styled(f"convs.{2 * j}", cin, cout)
        styled(f"convs.{2 * j + 1}", cout, cout)
        rgb(f"to_rgbs.{j}", cout)
        cin = cout
    for i in range((log_size - 2) * 2 + 1):
        size = 2 ** ((i + 5) // 2)
        sd[f"noises.noise_{i}"] = randn(1, 1, size, size)
    return sd


def _pair(jparams, w_space, via):
    jgen = JGenerator(resolution=RES, n_mlp=N_MLP, channel_multiplier=CM,
                      shift_in_w_space=w_space, tail_layout="nhwc")
    gen = StyleGAN2Generator(resolution=RES, n_mlp=N_MLP, channel_multiplier=CM,
                             shift_in_w_space=w_space).eval()
    if via == "from_jax":
        gen.load_state_dict(stylegan2_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return jgen, gen


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised params, and a fabricated g_ema with its JAX conversion."""
    jinit = JGenerator(resolution=RES, n_mlp=N_MLP, channel_multiplier=CM).init(
        jax.random.key(0))
    # Non-trivial noise weights and biases, so the noise path is exercised.
    rng = np.random.default_rng(2)
    for p in [jinit["conv1"]] + jinit["convs"]:
        p["noise_weight"] = jnp.asarray(np.float32(0.1 * rng.standard_normal()))
        p["act_bias"] = jnp.asarray(0.1 * rng.standard_normal(p["act_bias"].shape),
                                    jnp.float32)
    g_ema = fabricate_g_ema(3)
    return {"from_jax": (jinit, None),
            "g_ema": (stylegan2_params_from_state_dict(g_ema, RES), g_ema)}


@pytest.mark.parametrize("via", ["from_jax", "g_ema"])
@pytest.mark.parametrize("w_space", [False, True])
def test_generator_matches_jax(weights, via, w_space):
    jparams, g_ema = weights[via]
    jgen, gen = _pair(jparams, w_space, via)
    if g_ema is not None:
        load_reference_state_dict(gen, {"g_ema": g_ema})
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 512)).astype(np.float32)
    shift = (0.5 * rng.standard_normal((2, 512))).astype(np.float32)
    ref = np.asarray(jgen.apply(jparams, z, shift)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = gen.apply(torch.from_numpy(z), torch.from_numpy(shift)).numpy()
        w = gen.get_w(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 3, RES, RES)
    # f32 convolutions summed in another order; the repo's generator gate.
    p = psnr(got, ref)
    print(f"via={via} w_space={w_space}: PSNR {p:.1f} dB, "
          f"max abs err {np.max(np.abs(got - ref)):.3g}")
    assert p > 40.0, p
    np.testing.assert_allclose(w, np.asarray(jgen.get_w(jparams, z)), rtol=1e-4, atol=1e-4)
    if w_space:
        # latent_is_w: the caller maps z -> w and shifts in W.
        with torch.no_grad():
            got_w = gen.apply(torch.from_numpy(w), torch.from_numpy(shift),
                              latent_is_w=True).numpy()
        ref_w = np.asarray(jgen.apply(jparams, np.asarray(jgen.get_w(jparams, z)), shift,
                                      latent_is_w=True)).transpose(0, 3, 1, 2)
        assert psnr(got_w, ref_w) > 40.0


def test_truncation_and_mixing_match_jax(weights):
    jparams, _ = weights["from_jax"]
    jgen, gen = _pair(jparams, False, "from_jax")
    rng = np.random.default_rng(5)
    z1, z2 = (rng.standard_normal((2, 512)).astype(np.float32) for _ in range(2))
    mean_w = np.asarray(jgen.get_w(jparams, rng.standard_normal((64, 512)).astype(
        np.float32))).mean(0, keepdims=True)
    ref = np.asarray(jgen.forward(jparams, [z1, z2], inject_index=3, truncation=0.7,
                                  truncation_latent=mean_w)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = gen([torch.from_numpy(z1), torch.from_numpy(z2)], inject_index=3,
                  truncation=0.7, truncation_latent=torch.from_numpy(mean_w)).numpy()
    assert psnr(got, ref) > 40.0
