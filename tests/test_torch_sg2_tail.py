"""The port's StyleGAN2 tail (plain section, polyphase weights, routing) against
the JAX package, on the CPU.

Inputs and weights come from a numpy seed and go through both packages. The
JAX side runs as ``tests/test_sg2_tail_pallas.py`` runs it: ``fused_section``
in interpret mode on the fold-x layout (``ops/s2d.py::fold_x``), under
``jax.default_matmul_precision("highest")``, and the generator with
``tail_layout="pallas"`` (the kernel, interpreted) and ``"nhwc"`` (plain XLA
blocks). The port runs its plain versions (the CUDA kernel is held to them on
the card, ``tests/test_torch_sg2_tail_cuda.py``). Layouts: JAX NHWC/HWIO, the
port NCHW/OIHW.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from warpedganspace_tpu.models.stylegan2 import StyleGAN2Generator as JGenerator
from warpedganspace_tpu.ops import s2d as s2d_ops
from warpedganspace_tpu.ops import sg2_tail_pallas as stp
from warpedganspace_torch.convert.from_jax import stylegan2_from_jax
from warpedganspace_torch.models.stylegan2 import (StyledConv, StyleGAN2Generator, ToRGB,
                                                   channels_dict)
from warpedganspace_torch.ops import sg2_tail_cuda
from warpedganspace_torch.ops.sg2_tail import (compose_up_weight, fused_section_plain, modulate,
                                               modulated_conv, tail_start)

torch.set_num_threads(1)

NAMES = ("w_up", "w_same", "w_rgb", "s1", "d1", "s2", "d2", "s3",
         "n1", "nw1", "b1", "n2", "nw2", "b2", "rgb_b")


def section_arrays(seed, c, b, r):
    """One section's operands in the JAX layouts, away from the random init as
    in tests/test_sg2_tail_pallas.py: noise weights != 0, random biases, s and
    d away from 1."""
    rng = np.random.default_rng(seed)

    def f32(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    return dict(w_up=f32(3, 3, 2 * c, c, std=0.1), w_same=f32(3, 3, c, c, std=0.1),
                w_rgb=f32(1, 1, c, 3, std=0.2),
                s1=f32(b, 2 * c, mean=1.0, std=0.3), d1=f32(b, c, mean=1.0, std=0.2),
                s2=f32(b, c, mean=1.0, std=0.3), d2=f32(b, c, mean=1.0, std=0.2),
                s3=f32(b, c, mean=1.0, std=0.3),
                n1=f32(1, r, r, 1), nw1=np.float32(0.7), b1=f32(c, std=0.1),
                n2=f32(1, r, r, 1), nw2=np.float32(-0.4), b2=f32(c, std=0.1),
                rgb_b=np.asarray([0.05, -0.1, 0.2], np.float32))


def to_port(args):
    """HWIO -> OIHW, NHWC noise -> NCHW, scalars -> 0-dim tensors."""
    out = []
    for name in NAMES:
        a = np.asarray(args[name])
        if name.startswith("w_"):
            a = a.transpose(3, 2, 0, 1)
        elif name in ("n1", "n2"):
            a = a.transpose(0, 3, 1, 2)
        out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def jax_section(x_nhwc, args, want_x2):
    """The JAX kernel on the fold-x input; outputs back to NCHW."""
    c = args["w_up"].shape[3]
    b, h, w, _ = x_nhwc.shape
    xf = s2d_ops.fold_x(jnp.asarray(x_nhwc), 64 // c)
    with jax.default_matmul_precision("highest"):
        res = stp.fused_section(xf, want_x2=want_x2,
                                **{k: jnp.asarray(v) for k, v in args.items()})
    rgb, x2 = res if want_x2 else (res, None)
    rgb = np.asarray(rgb).reshape(b, 2 * h, 2 * w, 3).transpose(0, 3, 1, 2)
    if x2 is not None:
        x2 = np.asarray(x2).reshape(b, 2 * h, 2 * w, c).transpose(0, 3, 1, 2)
    return rgb, x2


# f32 sums of up to 9 * 128 products in another order: the bound
# tests/test_sg2_tail_pallas.py holds the TPU kernel to.
TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c,b", [(64, 2), (32, 2), (16, 1)])
def test_plain_section_matches_jax_kernel(c, b, want_x2):
    """wg = 8 fold-x groups: r = 16, 32, 64 output rows at C = 64, 32, 16."""
    r = 8 * 128 // c
    rng = np.random.default_rng(c)
    x = rng.standard_normal((b, r // 2, r // 2, 2 * c)).astype(np.float32)
    args = section_arrays(c + 1, c, b, r)
    ref_rgb, ref_x2 = jax_section(x, args, want_x2)
    with torch.no_grad():
        got = fused_section_plain(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                  *to_port(args), want_x2=want_x2)
    got_rgb, got_x2 = got if want_x2 else (got, None)
    np.testing.assert_allclose(got_rgb.numpy(), ref_rgb, **TOL)
    if want_x2:
        np.testing.assert_allclose(got_x2.numpy(), ref_x2, **TOL)


def test_plain_section_matches_jax_kernel_two_stripes():
    """r = 128 output rows, more than the f32 stripe of 64: the JAX kernel runs
    two row stripes with a halo between them."""
    c, b, r = 32, 1, 128
    x = np.random.default_rng(0).standard_normal((b, r // 2, r // 2, 2 * c)).astype(np.float32)
    args = section_arrays(1, c, b, r)
    ref_rgb, _ = jax_section(x, args, False)
    with torch.no_grad():
        got = fused_section_plain(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                  *to_port(args), want_x2=False)
    np.testing.assert_allclose(got.numpy(), ref_rgb, **TOL)


def _blocks(c, seed):
    """StyledConv(up) 2C -> C, StyledConv C -> C and ToRGB, with noise weights,
    biases and modulation biases away from their init."""
    gen = torch.Generator().manual_seed(seed)
    up = StyledConv(2 * c, c, 3, 512, upsample=True, generator=gen)
    same = StyledConv(c, c, 3, 512, generator=gen)
    rgb = ToRGB(c, 512, generator=gen)
    with torch.no_grad():
        for blk in (up, same):
            blk.noise_weight.fill_(0.3)
            blk.act_bias.copy_(0.1 * torch.randn(c, generator=gen))
        rgb.bias.copy_(torch.tensor([0.05, -0.1, 0.2]))
        for conv in (up.conv, same.conv, rgb.conv):
            conv.modulation.bias.add_(0.3 * torch.randn(conv.modulation.bias.shape, generator=gen))
    return up, same, rgb


@pytest.mark.parametrize("c", [64, 32, 16])
def test_plain_section_is_the_blocks(c):
    """The section is StyledConv(up) -> StyledConv -> ToRGB without the skip."""
    up, same, rgb = _blocks(c, c)
    gen = torch.Generator().manual_seed(7)
    b, h = 2, 6
    x = torch.randn((b, 2 * c, h, h), generator=gen)
    lat = torch.randn((3, b, 512), generator=gen)
    n1, n2 = (torch.randn((1, 1, 2 * h, 2 * h), generator=gen) for _ in range(2))
    with torch.no_grad():
        ref_x2 = same(up(x, lat[0], n1), lat[1], n2)
        ref_rgb = rgb(ref_x2, lat[2])
        s1, d1 = modulate(up.conv.weight, up.conv.modulation(lat[0]))
        s2, d2 = modulate(same.conv.weight, same.conv.modulation(lat[1]))
        s3 = rgb.conv.modulation(lat[2])
        got_rgb, got_x2 = fused_section_plain(
            x, up.conv.weight, same.conv.weight, rgb.conv.weight, s1, d1, s2, d2, s3,
            n1, up.noise_weight, up.act_bias, n2, same.noise_weight, same.act_bias, rgb.bias)
    # The same f32 operations in the same order.
    torch.testing.assert_close(got_x2, ref_x2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_rgb, ref_rgb, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 3), (1, 1)])
@pytest.mark.parametrize("c", [16, 32])
def test_polyphase_weights_are_the_up_conv(c, h, w):
    """The kernel's up-conv, four 3x3 convs of the input with the weights of
    ``compose_up_weight``, one per output phase (py, px), equals the stride-2
    transposed conv followed by the blur, borders included. Written here with
    explicit indices, as the kernel reads the [ci][phase][tap][co] layout."""
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn((2, 2 * c, h, w), generator=gen, dtype=torch.float64)
    w_up = torch.randn((c, 2 * c, 3, 3), generator=gen)
    ones = torch.ones((2, 2 * c), dtype=torch.float64)
    ref = modulated_conv(x, w_up.double(), ones, upsample=True)   # (2, C, 2h, 2w)
    comp = compose_up_weight(w_up).double()                       # (2C, 4, 9, C)
    assert tuple(comp.shape) == (2 * c, 4, 9, c)
    xp = F.pad(x, (1, 1, 1, 1))
    got = torch.zeros_like(ref)
    for py in range(2):
        for px in range(2):
            for oy in range(3):
                for ox in range(3):
                    # Output (2u + py, 2v + px) reads input (u - 1 + oy, v - 1 + ox).
                    patch = xp[:, :, oy:oy + h, ox:ox + w]
                    wt = comp[:, py * 2 + px, oy * 3 + ox]        # (2C, C)
                    got[:, :, py::2, px::2] += torch.einsum("bihw,io->bohw", patch, wt)
    # f32 weights composed exactly (products of 1/16-multiples), f64 sums.
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def small_pair(resolution, noise_seed=2):
    """A small JAX generator (2-layer mapping, channel multiplier 1) and the
    port's with the same weights through ``stylegan2_from_jax``; noise
    weights, biases and ToRGB biases made non-zero."""
    jgen = JGenerator(resolution=resolution, n_mlp=2, channel_multiplier=1)
    params = jgen.init(jax.random.key(0))
    rng = np.random.default_rng(noise_seed)
    for p in [params["conv1"]] + params["convs"]:
        p["noise_weight"] = jnp.asarray(np.float32(0.3 * rng.standard_normal()))
        p["act_bias"] = jnp.asarray(0.1 * rng.standard_normal(p["act_bias"].shape), jnp.float32)
    for p in [params["to_rgb1"]] + params["to_rgbs"]:
        p["bias"] = jnp.asarray(0.1 * rng.standard_normal(3), jnp.float32)
    gen = StyleGAN2Generator(resolution=resolution, n_mlp=2, channel_multiplier=1).eval()
    gen.load_state_dict(stylegan2_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jgen, params, gen


def psnr(img, ref):
    peak = float(ref.max() - ref.min())
    return 10 * math.log10(peak ** 2 / float(np.mean((img - ref) ** 2)))


@pytest.mark.parametrize("layout", ["pallas", "nhwc"])
@pytest.mark.parametrize("resolution,sections", [(256, 1), (512, 2)])
def test_generator_matches_jax_tail(resolution, sections, layout):
    """256 engages one section (C = 64); 512 two (C = 64, then C = 32, with the
    x2 hand-off between them)."""
    import dataclasses

    jgen, params, gen = small_pair(resolution)
    assert len(gen.to_rgbs) - gen.tail_start() == sections
    jgen = dataclasses.replace(jgen, tail_layout=layout)
    z = np.random.default_rng(4).standard_normal((1, 512)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jgen.apply(params, z)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = gen.apply(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (1, 3, resolution, resolution)
    # f32 convolutions of the whole generator summed in another order.
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=5e-5)
    assert psnr(got, ref) > 40.0


def _operands(c=16, b=2, h=3, w=5, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3), rnd(c, c, 3, 3), rnd(3, c, 1, 1),
            rnd(b, 2 * c), rnd(b, c), rnd(b, c), rnd(b, c), rnd(b, c),
            rnd(1, 1, 2 * h, 2 * w), rnd(), rnd(c), rnd(1, 1, 2 * h, 2 * w), rnd(), rnd(c),
            rnd(3)]


def _replace(ops, i, t):
    ops = list(ops)
    ops[i] = t
    return ops


@pytest.mark.parametrize("case,exc,match", [
    ("c8", ValueError, "C in"),
    ("w_same", ValueError, "w_same"),
    ("w_rgb", ValueError, "w_rgb"),
    ("s1", ValueError, "s1"),
    ("noise", ValueError, "n2"),
    ("nw", ValueError, "nw1"),
    ("dtype", TypeError, "share one dtype"),
    ("half", TypeError, "float32 or bfloat16"),
    ("strided", ValueError, "contiguous"),
])
def test_operand_checks_raise(case, exc, match):
    ops = _operands()
    if case == "c8":
        ops = _operands(c=8)
    elif case == "w_same":
        ops = _replace(ops, 2, ops[2][:, :8].contiguous())
    elif case == "w_rgb":
        ops = _replace(ops, 3, ops[3].reshape(3, 16))
    elif case == "s1":
        ops = _replace(ops, 4, ops[4][:, :16].contiguous())
    elif case == "noise":
        ops = _replace(ops, 12, ops[12][..., :-1].contiguous())
    elif case == "nw":
        ops = _replace(ops, 10, torch.ones(2))
    elif case == "dtype":
        ops = _replace(ops, 5, ops[5].bfloat16())
    elif case == "half":
        ops = _operands(dtype=torch.float16)
    elif case == "strided":
        ops = _replace(ops, 0, ops[0].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(exc, match=match):
        sg2_tail_cuda._check_operands(*ops)


def test_operand_checks_pass_and_cpu_takes_the_plain_version():
    ops = _operands()
    assert sg2_tail_cuda._check_operands(*ops) == 16
    before = sg2_tail_cuda.launches
    rgb, x2 = sg2_tail_cuda.fused_section(*ops)
    ref_rgb, ref_x2 = fused_section_plain(*ops)
    assert sg2_tail_cuda.launches == before
    assert torch.equal(rgb, ref_rgb) and torch.equal(x2, ref_x2)
    assert tuple(rgb.shape) == (2, 3, 6, 10) and tuple(x2.shape) == (2, 16, 6, 10)


@pytest.mark.parametrize("resolution,cm,n_tail", [
    (1024, 2, 2), (512, 2, 1), (256, 2, 0), (1024, 1, 3), (512, 1, 2), (256, 1, 1), (64, 1, 0)])
def test_tail_selection(resolution, cm, n_tail):
    """The trailing blocks with fewer than 128 output channels: config-f
    (channel multiplier 2) has two at 1024^2 (64 and 32 channels) and none at
    256^2."""
    ch = channels_dict(cm)
    blocks = [ch[2 ** i] for i in range(3, int(math.log2(resolution)) + 1)]
    assert len(blocks) - tail_start(blocks) == n_tail


def test_generator_tail_start_at_1024():
    gen = StyleGAN2Generator(resolution=1024, n_mlp=1)
    assert len(gen.to_rgbs) == 8 and gen.tail_start() == 6
