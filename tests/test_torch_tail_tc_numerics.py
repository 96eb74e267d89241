"""Where the bf16 tensor-core tail kernels round, emulated on the CPU.

The bf16 designs of ``warpedganspace_torch/csrc/proggan_tail.cu`` and
``sg2_tail.cu`` multiply bf16 operands on the tensor cores with float32
accumulation, and round in their own places:

- ProgGAN: the staged input after PixelNorm (computed in float32 from the bf16
  input) to bf16; the up-conv's merged weights (nearest-up + conv3x3 as four
  2x2 convs, one per parity of the output pixel, each merged tap the float32
  sum of two or four bf16 weights) to bf16; the mid tile after WScale,
  LeakyReLU and PixelNorm (float32) to bf16; the same-conv's epilogue and the
  RGB head's PixelNorm and 1x1 conv in float32 from the accumulators; the
  output to bf16. In the section with the RGB head those three intermediates
  are carried as bf16 hi + lo pairs instead (hi x hi + hi x lo + lo x hi in
  the up-conv, hi x W + lo x W in the same-conv), since the head's PixelNorm
  magnifies their rounding past the bound.
- StyleGAN2 (the wgmma design): the staged input x * s1 to bf16; the
  transposed conv's raw taps as the bf16 operands are (not rounded again)
  into a float32 pre-blur window, the blur in float32; the mid tile after
  * d1, noise, bias, leaky * sqrt 2 and * s2 (float32) to bf16; x2 in float32
  for ToRGB (x2 * s3 against the bf16 ToRGB weights, float32) and rounded to
  bf16 only where it is stored; the outputs to bf16. The mma.sync design
  kept for comparison (``ops/sg2_tail_polyphase.py``) takes the polyphase
  up-conv weights, composed in float32 (``compose_up_weight``), rounded to
  bf16, in place of the raw taps and the window; the rest alike.

The emulation below follows those rounding points in float32 arithmetic on
bf16-rounded values (float32 convolutions on the CPU stand for the tensor
cores' float32 accumulation). It lives in this file only, on no path of the
package. It is held at the card checks' bound of 3e-2 against the plain
section in float32 on the same rounded operands (what ``chip_smoke.py`` and
the card tests compare the kernels with), and no farther from it than the
port's plain bf16 section is (the card tests' second condition). Against the
plain bf16 section and the JAX package's bf16 twins (``_tail_jnp``, or the
jnp composition of one section without the head, for ProgGAN; the Pallas
``fused_section`` in interpret mode for StyleGAN2) it is held at 3e-2 plus
one bf16 ulp of outputs below 8: those round elsewhere, and are themselves up
to ~0.05 from the f32 section at these operands. Two alternatives the
designs did not take are emulated beside them: ProgGAN's nine raw taps of the
nearest-upsampled tile (exact weights, 2.25x the up-conv's products) and plain
bf16 roundings in the head's section, and StyleGAN2's polyphase composite
weights carried as a bf16 hi + lo pair (two products a tap). The operands follow ``chip_smoke.py``'s recipes (``tail_problem``,
``sg2_problem``) and the card tests' (``_problem``), made with numpy from
fixed seeds at small batches and sizes, border-only and ragged shapes among
them.

    PYTHONPATH=. python tests/test_torch_tail_tc_numerics.py   # prints the worst errors
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from warpedganspace_tpu.nn import core as jnn
from warpedganspace_tpu.ops import proggan_tail_pallas as ptp
from warpedganspace_tpu.ops import s2d as s2d_ops
from warpedganspace_tpu.ops import sg2_tail_pallas as stp
from warpedganspace_torch.ops import proggan_tail as pt
from warpedganspace_torch.ops import (proggan_tail_cuda, sg2_tail_cuda, sg2_tail_cuda_cores,
                                      sg2_tail_polyphase)
from warpedganspace_torch.ops import sg2_tail as st

torch.set_num_threads(1)

BOUND = 3e-2     # the card checks' bf16 bound, against the f32 section
# Against another bf16 section (the port's plain one, JAX's twin): that one
# rounds elsewhere and is itself up to ~0.05 from the f32 section here, and
# two bf16 roundings of one output below 8 may differ by an ulp, 2^-5. So the
# card bound plus that ulp.
PAIR_BOUND = BOUND + 2 ** -5
SQRT2 = 2.0 ** 0.5


def _bf(t):
    return t.bfloat16().float()


# --------------------------------------------------------------------------- ProgGAN

def _up_merged(xn, wm):
    """Nearest-up + conv3x3 as the four parity convs with merged taps ``wm``
    (as the package's ``merge_up_taps`` gives them), on an image of even origin."""
    b, _, h, w = xn.shape
    c = wm.shape[4]
    xp = F.pad(xn, (1, 1, 1, 1))
    out = xn.new_zeros((b, c, 2 * h, 2 * w))
    for py in range(2):             # parity of the image row: local parity 1 - py
        for px in range(2):
            k = wm[1 - py, 1 - px].permute(2, 3, 0, 1)          # (C, 2C, a, b)
            out[:, :, py::2, px::2] = F.conv2d(xp[:, :, py:py + h + 1, px:px + w + 1], k)
    return out


def _split(t):
    """t as the kernel carries it with the head: bf16 hi and the bf16 rounding
    of the remainder."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def emulate_proggan(x, w_up, b_up, s_up, w_same, b_same, s_same, head=None, design="shipped"):
    """The bf16 ProgGAN section kernel's arithmetic. ``design``: "shipped"
    (bf16 roundings; hi + lo pairs in the section with the head), "bf16"
    (bf16 roundings everywhere, the head's section too) or "raw" (nine raw
    taps of the nearest-upsampled tile instead of the merged ones)."""
    split = design == "shipped" and head is not None
    xn = pt.pixel_norm(x.float())
    if split:
        (xh, xl), (wh, wl) = _split(xn), _split(pt.merge_up_taps(w_up))
        m = _up_merged(xh, wh) + _up_merged(xh, wl) + _up_merged(xl, wh)
    elif design == "raw":
        m = F.conv2d(F.interpolate(_bf(xn), scale_factor=2, mode="nearest"), w_up.float(),
                     padding=1)
    else:
        m = _up_merged(_bf(xn), _bf(pt.merge_up_taps(w_up)))
    m = pt.pixel_norm(F.leaky_relu(pt.wscale(m, s_up.float(), b_up.float()), pt.LEAKY_SLOPE))
    if split:
        mh, ml = _split(m)
        y = F.conv2d(mh, w_same.float(), padding=1) + F.conv2d(ml, w_same.float(), padding=1)
    else:
        y = F.conv2d(_bf(m), w_same.float(), padding=1)
    y = F.leaky_relu(pt.wscale(y, s_same.float(), b_same.float()), pt.LEAKY_SLOPE)
    if head is not None:
        y = pt.head_plain(y, *(t.float() for t in head))
    return y.bfloat16()


def proggan_chip_problem(seed, b, c, h, w, head):
    """``chip_smoke.py::tail_problem``'s scales, from numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))

    ops = [normal(b, 2 * c, h, w), normal(c, 2 * c, 3, 3, std=(18 * c) ** -0.5),
           normal(c, std=0.3), torch.tensor([1.3]), normal(c, c, 3, 3, std=(9 * c) ** -0.5),
           normal(c, std=0.3), torch.tensor([0.8])]
    hd = (normal(3, c, 1, 1, std=c ** -0.5), normal(3, std=0.3), torch.tensor([1.1])) \
        if head else None
    return [t.bfloat16() for t in ops], None if hd is None else tuple(t.bfloat16() for t in hd)


def _jax_proggan_bf16(x, w_up, b_up, s_up, w_same, b_same, s_same, head):
    """The JAX package's bf16 composition: ``_tail_jnp`` for a section with the
    head; without it, the same blocks composed from the package's nn ops."""
    def j(t, conv=False):
        a = t.float().numpy()
        if conv:
            a = a.transpose(2, 3, 1, 0)                              # OIHW -> HWIO
        return jnp.asarray(a).astype(jnp.bfloat16)

    xj = j(x).transpose(0, 2, 3, 1)
    up = {"conv": {"w": j(w_up, True)}, "wscale_bias": j(b_up), "wscale_scale": j(s_up)[0]}
    same = {"conv": {"w": j(w_same, True)}, "wscale_bias": j(b_same),
            "wscale_scale": j(s_same)[0]}
    if head is not None:
        out = {"conv": {"w": j(head[0], True)}, "wscale_bias": j(head[1]),
               "wscale_scale": j(head[2])[0]}
        y = ptp._tail_jnp(xj, [{"up": up, "same": same}], out)
    else:
        y = xj
        for p, upsample in ((up, True), (same, False)):
            y = jnn.pixel_norm(y)
            if upsample:
                y = jnn.upsample_nearest(y, 2)
            y = jnn.conv2d(p["conv"], y, padding=1) * p["wscale_scale"] + p["wscale_bias"]
            y = jnp.where(y >= 0, y, jnp.asarray(0.2, y.dtype) * y)
    return torch.from_numpy(np.array(y.astype(jnp.float32))).permute(0, 3, 1, 2)


def proggan_errors(ops, head, design="shipped", jax_twin=True):
    """Max abs of the emulation against the f32 plain section on the same
    rounded operands, against the plain bf16 section and against JAX's bf16
    twin; and the plain bf16 section's own distance from the f32 one."""
    got = emulate_proggan(*ops, head=head, design=design).float()
    ref = pt.fused_section_plain(*[t.float() for t in ops],
                                 head=None if head is None else tuple(t.float() for t in head))
    plain16 = pt.fused_section_plain(*ops, head=head).float()
    errs = {"f32": float((got - ref).abs().max()), "plain_bf16": float((got - plain16).abs().max()),
            "plain_bf16_vs_f32": float((plain16 - ref).abs().max())}
    if jax_twin:
        errs["jax_bf16"] = float((got - _jax_proggan_bf16(*ops, head)).abs().max())
    return errs


# (seed, B, C, H, W, head): the three full-width sections' C at small sizes,
# border-only (a 2 x 2 output), ragged, odd and non-square.
PROGGAN_CASES = [
    (5, 2, 64, 8, 8, False), (5, 2, 32, 16, 16, False), (5, 2, 16, 32, 32, True),
    (5, 3, 16, 1, 1, True), (5, 3, 64, 1, 1, False),
    (5, 2, 32, 9, 23, False), (5, 2, 16, 17, 5, True),
]


@pytest.mark.parametrize("seed,b,c,h,w,head", PROGGAN_CASES)
def test_proggan_emulation_within_bound(seed, b, c, h, w, head):
    errs = proggan_errors(*proggan_chip_problem(seed, b, c, h, w, head))
    assert errs["f32"] <= BOUND, errs
    assert errs["jax_bf16"] <= PAIR_BOUND, errs


@pytest.mark.parametrize("seed,b,c,h,w,head", PROGGAN_CASES)
def test_proggan_emulation_against_plain_bf16(seed, b, c, h, w, head):
    """Against the plain bf16 section, which rounds every intermediate: within
    the pair bound, and nearer to the f32 section than the plain bf16 one is
    (the card tests' second condition)."""
    errs = proggan_errors(*proggan_chip_problem(seed, b, c, h, w, head), jax_twin=False)
    assert errs["plain_bf16"] <= PAIR_BOUND, errs
    assert errs["f32"] <= errs["plain_bf16_vs_f32"] + 1e-6, errs


def test_proggan_merged_taps_are_exact_in_f32():
    """The parity convs with merged taps are nearest-up + conv3x3, exactly up
    to float32 sums (so the only new rounding is the merged taps' bf16)."""
    ops, _ = proggan_chip_problem(1, 2, 16, 5, 7, False)
    x, w_up = ops[0].float(), ops[1].float()
    got = _up_merged(x, pt.merge_up_taps(w_up))
    want = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w_up, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [16, 64])
def test_proggan_kernel_weight_layout(c):
    """What the wrapper hands the bf16 kernel, read as the kernel reads it
    ([hi, lo][tap (a, b)][parity (pi, pj)][co][ci]; [tap][co][ci]), is the
    merged nearest-up + conv3x3 and the same-conv: hi the bf16 rounding of
    each merged tap, hi + lo within 2^-16 of it."""
    ops, _ = proggan_chip_problem(11, 1, c, 5, 7, False)
    w_up, w_same = ops[1], ops[4]
    wup, ws = proggan_tail_cuda.tc_weights(w_up, w_same)
    assert wup.dtype == ws.dtype == torch.bfloat16
    assert tuple(wup.shape) == (2, 4, 4, c, 2 * c) and tuple(ws.shape) == (9, c, c)
    merged = pt.merge_up_taps(w_up)
    read = wup.float().reshape(2, 2, 2, 2, 2, c, 2 * c).permute(0, 3, 4, 1, 2, 5, 6)
    assert torch.equal(read[0], merged.bfloat16().float())
    assert float((read[0] + read[1] - merged).abs().max()) <= 2 ** -16 * float(merged.abs().max())
    x = ops[0].float()
    got = _up_merged(x, read[0] + read[1])
    want = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w_up.float(), padding=1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(ws.reshape(3, 3, c, c).permute(2, 3, 0, 1), w_same)


@pytest.mark.parametrize("design", ["shipped", "raw"])
def test_proggan_tap_options(design):
    """Merged taps rounded to bf16 (shipped) and the nine raw taps both hold
    the bound at the full-width C = 64, where the section has no head."""
    errs = proggan_errors(*proggan_chip_problem(7, 2, 64, 8, 8, False), design=design,
                          jax_twin=False)
    assert errs["f32"] <= BOUND, errs


def test_proggan_head_needs_the_split():
    """At C = 16 with the RGB head, bf16 roundings of the normalised input, the
    merged taps and the mid tile break the bound (the head's PixelNorm magnifies
    them at pixels whose 16 channels are all small); the hi + lo pairs leave
    only the output's rounding."""
    ops, hd = proggan_chip_problem(9, 1, 16, 128, 128, True)
    assert proggan_errors(ops, hd, design="bf16", jax_twin=False)["f32"] > BOUND
    assert proggan_errors(ops, hd, jax_twin=False)["f32"] <= 2 ** -6


# --------------------------------------------------------------------------- StyleGAN2

def emulate_sg2(x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b,
                want_x2=True, design="wgmma", weights="bf16"):
    """The bf16 StyleGAN2 section kernel's arithmetic. ``design``: "wgmma"
    (shipped: the raw taps' transposed conv into a float32 window, then the
    blur) or "polyphase" (the mma.sync design kept for comparison: four
    polyphase 3x3 convs of the composite weights); for the polyphase design
    ``weights="hilo"`` is the alternative that carries each composite weight
    as bf16 hi + lo."""
    f = [t.float() for t in (x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2,
                             b2, rgb_b)]
    x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b = f
    bsz, _, h, w = x.shape
    c = w_up.shape[0]
    xs = _bf(x * s1[:, :, None, None])
    if design == "wgmma":
        m = st.modulated_conv(xs, _bf(w_up), torch.ones_like(s1), upsample=True)
        m = m * d1[:, :, None, None]
    else:
        comp = st.compose_up_weight(w_up)                             # (2C, 4, 9, C)
        wq = _bf(comp) if weights == "bf16" else _bf(comp) + _bf(comp - _bf(comp))
        m = x.new_zeros((bsz, c, 2 * h, 2 * w))
        for ph in range(4):
            k = wq[:, ph].reshape(2 * c, 3, 3, c).permute(3, 0, 1, 2)  # (C, 2C, oy, ox)
            m[:, :, ph // 2::2, ph % 2::2] = F.conv2d(xs, k, padding=1)
        m = m * d1[:, :, None, None]
    m = m + nw1.reshape(()) * n1 + b1[None, :, None, None]
    m = _bf(SQRT2 * F.leaky_relu(m, 0.2) * s2[:, :, None, None])
    y = F.conv2d(m, w_same, padding=1) * d2[:, :, None, None]
    x2 = SQRT2 * F.leaky_relu(y + nw2.reshape(()) * n2 + b2[None, :, None, None], 0.2)
    rgb = F.conv2d(x2 * s3[:, :, None, None], w_rgb) + rgb_b[None, :, None, None]
    return (rgb.bfloat16(), x2.bfloat16()) if want_x2 else rgb.bfloat16()


def sg2_chip_problem(seed, b, c, h, w):
    """``chip_smoke.py::sg2_problem``'s scales, from numpy."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32))

    ops = [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3, std=0.5 * (18 * c) ** -0.5),
           rnd(c, c, 3, 3, std=0.5 * (9 * c) ** -0.5), rnd(3, c, 1, 1, std=0.5 * c ** -0.5),
           rnd(b, 2 * c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(0.7), rnd(c, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(-0.4), rnd(c, std=0.3), rnd(3, std=0.3)]
    return [t.bfloat16() for t in ops]


def _jax_sg2_bf16(ops, want_x2):
    """The JAX package's Pallas section in bf16, interpreted on the CPU, on
    the fold-x input it takes (outputs back to NCHW)."""
    x = ops[0]
    b, _, h, w = x.shape
    c = ops[1].shape[0]
    args = {}
    for name, t in zip(("w_up", "w_same", "w_rgb", "s1", "d1", "s2", "d2", "s3", "n1", "nw1",
                        "b1", "n2", "nw2", "b2", "rgb_b"), ops[1:]):
        a = t.float().numpy()
        if name.startswith("w_"):
            a = a.transpose(2, 3, 1, 0)                              # OIHW -> HWIO
        elif name in ("n1", "n2"):
            a = a.transpose(0, 2, 3, 1)
        args[name] = jnp.asarray(a).astype(jnp.bfloat16)
    xf = s2d_ops.fold_x(jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1)).astype(jnp.bfloat16),
                        64 // c)
    res = stp.fused_section(xf, want_x2=want_x2, **args)
    rgb, x2 = res if want_x2 else (res, None)
    out = [np.asarray(rgb.astype(jnp.float32)).reshape(b, 2 * h, 2 * w, 3)]
    if want_x2:
        out.append(np.asarray(x2.astype(jnp.float32)).reshape(b, 2 * h, 2 * w, c))
    return [torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in out]


def sg2_errors(ops, want_x2, design="wgmma", weights="bf16", jax_twin=False):
    """As ``proggan_errors``, the worst of rgb and x2."""
    got = emulate_sg2(*ops, want_x2=want_x2, design=design, weights=weights)
    ref = st.fused_section_plain(*[t.float() for t in ops], want_x2=want_x2)
    plain16 = st.fused_section_plain(*ops, want_x2=want_x2)
    got, ref, plain16 = ((got, ref, plain16) if want_x2 else ((got,), (ref,), (plain16,)))

    def worst(a, b):
        return max(float((p.float() - q.float()).abs().max()) for p, q in zip(a, b))

    errs = {"f32": worst(got, ref), "plain_bf16": worst(got, plain16),
            "plain_bf16_vs_f32": worst(plain16, ref)}
    if jax_twin:
        errs["jax_bf16"] = worst(got, _jax_sg2_bf16(ops, want_x2))
    return errs


# (seed, B, C, H, W, want_x2): the two full-width sections' C, C = 16,
# border-only (2 x 2 and 4 x 4 outputs), ragged, odd and non-square.
SG2_CASES = [
    (6, 2, 64, 8, 8, True), (6, 2, 32, 16, 16, False), (6, 2, 16, 16, 16, True),
    (6, 3, 16, 1, 1, False), (6, 3, 64, 2, 2, True),
    (6, 2, 32, 13, 7, True), (6, 2, 64, 13, 7, False),
]
# The fold-x layout of the JAX kernel: 8 groups of 64 // C pixels a row, so a
# row of 8 * 64 // C input pixels.
SG2_JAX_CASES = [(6, 1, 64, 8, 8, True), (6, 1, 32, 16, 16, False), (6, 1, 16, 32, 32, True)]


@pytest.mark.parametrize("seed,b,c,h,w,want_x2", SG2_CASES)
def test_sg2_emulation_within_bound(seed, b, c, h, w, want_x2):
    """The shipped wgmma design's roundings."""
    errs = sg2_errors(sg2_chip_problem(seed, b, c, h, w), want_x2)
    assert errs["f32"] <= BOUND, errs
    assert errs["f32"] <= errs["plain_bf16_vs_f32"] + 1e-6, errs
    assert errs["plain_bf16"] <= PAIR_BOUND, errs


@pytest.mark.parametrize("seed,b,c,h,w,want_x2", SG2_CASES)
def test_sg2_polyphase_emulation_within_bound(seed, b, c, h, w, want_x2):
    """The polyphase mma.sync design's roundings, kept for comparison: the
    same bounds at the same cases."""
    errs = sg2_errors(sg2_chip_problem(seed, b, c, h, w), want_x2, design="polyphase")
    assert errs["f32"] <= BOUND, errs
    assert errs["f32"] <= errs["plain_bf16_vs_f32"] + 1e-6, errs
    assert errs["plain_bf16"] <= PAIR_BOUND, errs


@pytest.mark.parametrize("seed,b,c,h,w,want_x2", SG2_JAX_CASES)
def test_sg2_emulation_against_jax_bf16(seed, b, c, h, w, want_x2):
    errs = sg2_errors(sg2_chip_problem(seed, b, c, h, w), want_x2, jax_twin=True)
    assert errs["jax_bf16"] <= PAIR_BOUND, errs


@pytest.mark.parametrize("c", [16, 32])
def test_sg2_kernel_weight_layout(c):
    """What the wrapper hands each design, read as the kernel reads it: for
    bf16 the transposed conv's raw taps in ``UP_TAP_ORDER`` and the
    same-conv's taps, [tap][co][ci], as the wgmma core matrices ([tap][k16
    step][n8 group][k half][n][k]) hold them, the operands' own values, whose
    transposed conv over the taps' parity groups is the plain one. For f32 the
    split-precision design's records of the same taps
    (tests/test_torch_sg2_tail_f32_split_numerics.py reads them at the
    kernel's indices). For the designs kept for comparison: the polyphase
    up-conv [tap (oy, ox)][phase (py, px)][co][ci], each composite rounded
    once, which as four 3x3 convs is the transposed conv and blur, and the
    same-conv [tap][co][ci] (``sg2_tail_polyphase.polyphase_weights``); the
    CUDA-core design's [ci][phase][tap][co] and [ci][ky][kx][co]."""
    ops = sg2_chip_problem(12, 1, c, 6, 5)
    w_up, w_same, w_rgb = ops[1:4]
    wu, ws, wr = sg2_tail_cuda.kernel_weights(w_up, w_same, w_rgb, torch.bfloat16)
    assert wu.dtype == ws.dtype == torch.bfloat16 and wr.dtype == torch.float32
    assert tuple(wu.shape) == (9, 2 * c // 16, c // 8, 2, 8, 8)
    assert tuple(ws.shape) == (9, c // 16, c // 8, 2, 8, 8)
    # The byte offset of (n, k) in a chunk: 32 N (k // 16) + 256 (n // 8) + 128
    # (k % 16 // 8) + 16 (n % 8) + 2 (k % 8), what the descriptor reads.
    n, k = torch.meshgrid(torch.arange(c), torch.arange(2 * c), indexing="ij")
    offset = 32 * c * (k // 16) + 256 * (n // 8) + 128 * (k % 16 // 8) + 16 * (n % 8) + 2 * (k % 8)
    up = wu.reshape(9, -1)[:, offset // 2]                            # (9, C, 2C) [tap][co][ci]
    for t, (ky, kx) in enumerate(sg2_tail_cuda.UP_TAP_ORDER):
        assert torch.equal(up[t], w_up[:, :, ky, kx])
    n, k = n[:, :c], k[:, :c]
    offset = 32 * c * (k // 16) + 256 * (n // 8) + 128 * (k % 16 // 8) + 16 * (n % 8) + 2 * (k % 8)
    same = ws.reshape(9, -1)[:, offset // 2]
    assert torch.equal(same.reshape(3, 3, c, c).permute(2, 3, 0, 1), w_same)
    assert torch.equal(wr, w_rgb.float().reshape(3, c))
    # The taps' parity groups of the 21 x 21 window (all of them here) are the
    # plain transposed conv.
    x = ops[0].float()
    got = x.new_zeros((1, c, 13, 11))
    for t, (ky, kx) in enumerate(sg2_tail_cuda.UP_TAP_ORDER):
        tap = up[t].float()                                           # (C, 2C)
        got[:, :, ky:ky + 11:2, kx:kx + 9:2] += torch.einsum("oi,bihw->bohw", tap, x)
    want = F.conv_transpose2d(x, w_up.float().transpose(0, 1), stride=2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    wu32, ws32, wr32 = sg2_tail_cuda.kernel_weights(w_up, w_same, w_rgb, torch.float32)
    w_up, w_same = w_up.float(), w_same.float()
    up = torch.stack([w_up[:, :, ky, kx] for ky, kx in sg2_tail_cuda.UP_TAP_ORDER])
    assert torch.equal(wu32, sg2_tail_cuda.split_records(up))
    assert torch.equal(ws32, sg2_tail_cuda.split_records(
        w_same.permute(2, 3, 0, 1).reshape(9, c, c)))
    assert torch.equal(wr32, wr)
    wup, wsp, wrp = sg2_tail_polyphase.polyphase_weights(*ops[1:4])
    assert wup.dtype == wsp.dtype == torch.bfloat16 and wrp.dtype == torch.float32
    assert tuple(wup.shape) == (9, 4, c, 2 * c) and tuple(wsp.shape) == (9, c, c)
    comp = st.compose_up_weight(w_up)
    assert torch.equal(wup.float().permute(3, 1, 0, 2), comp.bfloat16().float())
    got = x.new_zeros((1, c, 12, 10))
    for ph in range(4):
        k = wup.float()[:, ph].reshape(3, 3, c, 2 * c).permute(2, 3, 0, 1)
        got[:, :, ph // 2::2, ph % 2::2] = F.conv2d(x, k, padding=1)
    want = st.modulated_conv(x, w_up, torch.ones(1, 2 * c), upsample=True)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2 ** -7 * scale
    assert torch.equal(wsp.float().reshape(3, 3, c, c).permute(2, 3, 0, 1), w_same)
    assert torch.equal(wrp, wr)
    wucc, wscc, _ = sg2_tail_cuda_cores.cc_weights(w_up, w_same, w_rgb)
    assert torch.equal(wucc, st.compose_up_weight(w_up))
    assert torch.equal(wscc, w_same.permute(1, 2, 3, 0))


@pytest.mark.parametrize("weights", ["bf16", "hilo"])
def test_sg2_weight_options(weights):
    """Both ways to carry the polyphase design's composite weights hold the
    bound at C = 64."""
    errs = sg2_errors(sg2_chip_problem(7, 2, 64, 8, 8), True, design="polyphase",
                      weights=weights)
    assert errs["f32"] <= BOUND, errs


def test_sg2_composite_rounding_is_the_new_one():
    """The emulation is not the plain bf16 section under another name: it
    rounds other values (x * s1, the mid tile after * s2; the polyphase
    design also the composite weights), so its bits differ, by about one
    bf16 ulp of the outputs."""
    ops = sg2_chip_problem(8, 2, 16, 8, 8)
    plain16 = st.fused_section_plain(*ops, want_x2=False)
    for design in ("wgmma", "polyphase"):
        got = emulate_sg2(*ops, want_x2=False, design=design)
        assert not torch.equal(got, plain16)
        assert float((got.float() - plain16.float()).abs().max()) <= PAIR_BOUND


def _report():
    rows = []
    for case in PROGGAN_CASES:
        seed, b, c, h, w, head = case
        ops, hd = proggan_chip_problem(seed, b, c, h, w, head)
        e = proggan_errors(ops, hd)
        for alt in ("bf16", "raw"):
            e[alt + "_f32"] = proggan_errors(ops, hd, design=alt, jax_twin=False)["f32"]
        rows.append(("proggan", case, e))
    for case in SG2_CASES:
        seed, b, c, h, w, x2 = case
        ops = sg2_chip_problem(seed, b, c, h, w)
        e = sg2_errors(ops, x2)
        e["polyphase_f32"] = sg2_errors(ops, x2, design="polyphase")["f32"]
        e["polyphase_hilo_f32"] = sg2_errors(ops, x2, design="polyphase", weights="hilo")["f32"]
        rows.append(("sg2", case, e))
    for case in SG2_JAX_CASES:
        seed, b, c, h, w, x2 = case
        rows.append(("sg2 jax", case, sg2_errors(sg2_chip_problem(seed, b, c, h, w), x2,
                                                 jax_twin=True)))
    for kind, case, e in rows:
        print(f"{kind} {case}: " + ", ".join(f"{k} {v:.4g}" for k, v in e.items()))
    for kind in ("proggan", "sg2"):
        worst = max(e["f32"] for k, _, e in rows if k == kind)
        print(f"worst {kind} vs f32 plain on the same rounded operands: {worst:.4g}")


if __name__ == "__main__":
    _report()
