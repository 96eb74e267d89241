"""Where the float32 tensor-core StyleGAN2 tail kernel rounds, emulated on the CPU.

The float32 design of ``warpedganspace_torch/csrc/sg2_tail.cu`` (``namespace
tf``) computes one tail section per 16 x 16 output tile:

- the stride-2 transposed conv of the staged input tile x * s1 (12 x 12
  pixels from (y0 / 2 - 2, x0 / 2 - 2), zero outside the image) into a
  pre-blur window T of 21 x 21 pixels from (y0 - 2, x0 - 2), parity group by
  parity group: window pixel (2u + pr, 2v + pc) takes the taps ky = pr, kx =
  pc (mod 2), and tap (ky, kx) reads input pixel (u + 1 - ky // 2, v + 1 -
  kx // 2); the groups (0, 0), (0, 1), (1, 0), (1, 1) in that order, their
  taps in ``sg2_tail_cuda.UP_TAP_ORDER``;
- the separable [1, 3, 3, 1] / 4 blur in float32, columns then rows, each
  tap fmaf(0.75, t1 + t2, 0.25 (t0 + t3)); then fmaf(blur, d1, nw1 n1 + b1),
  leaky * sqrt 2 and * s2 give the 18 x 18 mid tile from (y0 - 1, x0 - 1),
  zero outside the image;
- the same-conv of the mid tile, taps (ky, kx) in row-major order;
- fmaf(sum, d2, nw2 n2 + b2), leaky * sqrt 2 is x2; ToRGB of x2 * s3 as four
  lanes' partials over channels 2 tq, 2 tq + 1 of each n8 tile, added as (p0 +
  p1) + (p2 + p3), then the bias.

Both convolutions run on the tensor cores in split precision (3xTF32,
``tests/split_precision.py``): each weight chunk (one tap x 16 input
channels, two k8 steps) is a ``mma.sync`` m16n8k8 per k8 step and pair of
pieces, lo hi, hi lo, hi hi, each adding its exact products into a float32
accumulator and rounding toward zero; every ``FLUSH_CHUNKS`` chunks (and at the
end of a parity group) the accumulators are added into float32 sums, rounded
to nearest, and start again from 0. The weights' pieces are read from the
records :func:`~warpedganspace_torch.ops.sg2_tail_cuda.kernel_weights` gives
the kernel, at the kernel's indices, so the emulation checks their layout too.

The emulation lives in this file only, on no path of the package. It is held
to the plain float32 section within the card tests' 1e-4, to the JAX
package's Pallas ``fused_section`` run in interpret mode as
``tests/test_torch_sg2_tail.py`` runs it, and, in float64 without rounding
(raw weights, no pieces), to the plain section in float64 within 1e-10 at
ragged shapes: that checks the index arithmetic of the tiles, windows,
parities and taps. One TF32 product (hi only), and one chain of products
over each parity group's K without flushes, are emulated beside it. The
signed mean error (the error along the reference's sign, over its mean
magnitude) against float64 is the card tests' bias check. Operands follow
``chip_smoke.py::sg2_problem``'s recipe, made with numpy from fixed seeds.

    PYTHONPATH=. python tests/test_torch_sg2_tail_f32_split_numerics.py   # prints the errors
"""
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.split_precision import round_toward_zero, split_pieces, tf32
from tests.test_torch_sg2_tail import jax_section, section_arrays, to_port
from warpedganspace_torch.ops import sg2_tail_cuda
from warpedganspace_torch.ops.sg2_tail import fused_section_plain

torch.set_num_threads(1)

TILE, WIN, MID, IN_WIN, EVEN = 16, 21, 18, 12, 11
CHUNK_STEPS = 2           # k8 steps (16 input channels) of a weight chunk
FLUSH_CHUNKS = 2          # kFlushSteps = 4 of csrc/sg2_tail.cu: chains of 12 products
BOUND = 1e-4              # the card tests' float32 bound against the plain section
EXACT_BOUND = 1e-10       # float64 without rounding against the plain section in float64
MARGIN = 2.0              # the shipped split must hold BOUND this many times over
SME_BOUND = 1e-6          # the card tests' bound on the signed mean error against float64
SLOPE = float(np.float32(0.2))
GAIN = float(np.float32(math.sqrt(2.0)))
# The pairs of pieces of a k8 step, in the kernel's order (tc_tf32.cuh's
# mma3_records): (A piece, B piece), 0 = hi, 1 = lo.
PAIRS = {"3xtf32": ((1, 0), (0, 1), (0, 0)), "tf32": ((0, 0),)}


def problem(seed, b, c, h, w):
    """``chip_smoke.py::sg2_problem``'s scales from numpy: unit-scale input,
    each conv output at a scale of one half, noise weights != 0, random
    biases, s and d away from 1."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32))

    return [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3, std=0.5 * (18 * c) ** -0.5),
            rnd(c, c, 3, 3, std=0.5 * (9 * c) ** -0.5), rnd(3, c, 1, 1, std=0.5 * c ** -0.5),
            rnd(b, 2 * c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
            rnd(b, c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
            rnd(b, c, mean=1.0, std=0.3),
            rnd(1, 1, 2 * h, 2 * w), torch.tensor(0.7), rnd(c, std=0.3),
            rnd(1, 1, 2 * h, 2 * w), torch.tensor(-0.4), rnd(c, std=0.3), rnd(3, std=0.3)]


def _decode(records, c_out):
    """The kernel's view of split records (chunks, 2, C/8, 32, 4): (hi, lo),
    each (chunks, 2 k8 steps, 8 k, C out) float64 -- lane 4 gq + tq holds
    {hi b0, hi b1, lo b0, lo b1} of (k tq, n gq) and (k tq + 4, n gq)."""
    # (j, s, nt, gq, tq, hl, half) -> (hl, j, s, half, tq, nt, gq)
    r = records.double().reshape(records.shape[0], 2, c_out // 8, 8, 4, 2, 2)
    r = r.permute(5, 0, 1, 6, 4, 2, 3)
    return r.reshape(2, records.shape[0], 2, 8, c_out)


def _raw_chunks(taps, ci_n):
    """Raw float64 weights as chunks: (taps x ci / 16, 2, 8, C out) from
    (taps, C out, C in)."""
    t, co, _ = taps.shape
    return taps.double().permute(0, 2, 1).reshape(t * (ci_n // 16), 2, 8, co)


def _fma(a, b, c):
    """fmaf in float32: a b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def conv_products(windows, chunks, split, flush_chunks):
    """The implicit GEMM's products over the chunks of one accumulator, as
    the kernel chains them: the sum over chunks j of the A window
    ``windows(j)`` (..., 16, P) times B chunk j, (..., C, P). ``split=None``:
    ``chunks`` are float64 weights (2, 8, C) and the sum is exact; else they
    are (hi, lo) pairs and each k8 step is a mma.sync per pair of pieces,
    rounding toward zero, flushed every ``flush_chunks`` chunks."""
    if split is None:
        total = 0.0
        for j, wb in enumerate(chunks):
            total = total + torch.einsum("...kp,kn->...np", windows(j).double(),
                                         wb.reshape(16, -1))
        return total
    acc = total = None
    since = 0
    for j, pb in enumerate(chunks):
        pa = split_pieces(windows(j), split)
        for s in range(CHUNK_STEPS):
            ks = slice(8 * s, 8 * s + 8)
            for ia, ib in PAIRS[split]:
                prod = torch.einsum("...kp,kn->...np", pa[ia][..., ks, :].double(), pb[ib][s])
                acc = round_toward_zero(prod if acc is None else acc.double() + prod)
        since += 1
        if flush_chunks is not None and since == flush_chunks:
            total = acc if total is None else total + acc
            acc, since = None, 0
    if acc is not None:
        total = acc if total is None else total + acc
    return total


def emulate(ops, want_x2=True, split="3xtf32", flush_chunks=FLUSH_CHUNKS):
    """The float32 kernel's arithmetic on one section's operands under
    ``split``; ``split=None`` runs the same tiles, windows and taps in float64
    without rounding. Returns (rgb, x2) or rgb."""
    exact = split is None
    dt = torch.float64 if exact else torch.float32
    x, w_up, w_same, w_rgb, s1, d1, s2, d2, s3, n1, nw1, b1, n2, nw2, b2, rgb_b = [
        t.to(dt) for t in ops]
    bsz, ci, hi, wi = x.shape
    c = ci // 2
    h, w = 2 * hi, 2 * wi
    ty, tx = -(-h // TILE), -(-w // TILE)
    slope, gain = (0.2, math.sqrt(2.0)) if exact else (SLOPE, GAIN)

    def act(v):
        return gain * torch.where(v >= 0, v, slope * v)

    if exact:
        up = torch.stack([w_up[:, :, ky, kx] for ky, kx in sg2_tail_cuda.UP_TAP_ORDER])
        up_chunks = list(_raw_chunks(up, ci))
        same_chunks = list(_raw_chunks(w_same.permute(2, 3, 0, 1).reshape(9, c, c), c))
    else:
        wu_rec, ws_rec, _ = sg2_tail_cuda.kernel_weights(w_up, w_same, w_rgb, torch.float32)
        up_chunks = list(zip(*_decode(wu_rec, c)))
        same_chunks = list(zip(*_decode(ws_rec, c)))

    # Input tiles x * s1: (B, tiles, 2C, 12, 12), zero outside the image.
    xs = x * s1[:, :, None, None]
    xp = F.pad(xs, (2, 8 * tx + 2 - wi, 2, 8 * ty + 2 - hi))
    tiles = xp.unfold(2, IN_WIN, 8).unfold(3, IN_WIN, 8)               # B, 2C, ty, tx, 12, 12
    tiles = tiles.permute(0, 2, 3, 1, 4, 5).reshape(bsz, ty * tx, ci, IN_WIN, IN_WIN)

    # The transposed conv into T, parity group by parity group.
    t_win = torch.zeros((bsz, ty * tx, c, WIN, WIN), dtype=dt)
    j0 = 0
    for pr, pc in ((0, 0), (0, 1), (1, 0), (1, 1)):
        nr, nc = EVEN - pr, EVEN - pc
        taps = [(ky, kx) for ky, kx in sg2_tail_cuda.UP_TAP_ORDER
                if ky % 2 == pr and kx % 2 == pc]
        kb_n = ci // 16

        def window(j, taps=taps, nr=nr, nc=nc, kb_n=kb_n):
            ky, kx = taps[j // kb_n]
            kb = j % kb_n
            a = tiles[:, :, 16 * kb:16 * kb + 16, 1 - ky // 2:1 - ky // 2 + nr,
                      1 - kx // 2:1 - kx // 2 + nc]
            return a.reshape(bsz, ty * tx, 16, nr * nc)

        n_chunks = len(taps) * kb_n
        got = conv_products(window, up_chunks[j0:j0 + n_chunks], split, flush_chunks)
        j0 += n_chunks
        t_win[:, :, :, pr::2, pc::2] = got.reshape(bsz, ty * tx, c, nr, nc).to(dt)
    assert j0 == len(up_chunks)

    # The blur in place: the columns, then the rows with the epilogue.
    def blur4(t0, t1, t2, t3):
        if exact:
            return 0.75 * (t1 + t2) + 0.25 * (t0 + t3)
        return _fma(torch.full_like(t1, 0.75), t1 + t2, 0.25 * (t0 + t3))

    v = blur4(*(t_win[..., a:a + MID, :] for a in range(4)))          # ..., 18, 21
    v = blur4(*(v[..., a:a + MID] for a in range(4)))                 # ..., 18, 18
    gy = (TILE * torch.arange(ty)[:, None] - 1 + torch.arange(MID)[None, :])   # ty, 18
    gx = (TILE * torch.arange(tx)[:, None] - 1 + torch.arange(MID)[None, :])   # tx, 18
    inside = (((gy >= 0) & (gy < h))[:, None, :, None]
              & ((gx >= 0) & (gx < w))[None, :, None, :]).reshape(ty * tx, 1, MID, MID)
    n1p = F.pad(n1[0, 0], (1, TILE * tx + 1 - w, 1, TILE * ty + 1 - h))
    n1t = n1p.unfold(0, MID, TILE).unfold(1, MID, TILE).reshape(ty * tx, 1, MID, MID)
    nz = nw1 * n1t                                                     # tiles, 1, 18, 18
    bias = nz[None] + b1[None, None, :, None, None]
    pre = (v * d1[:, None, :, None, None] + bias if exact
           else _fma(v, d1[:, None, :, None, None].expand_as(v), bias))
    mid = torch.where(inside[None], act(pre) * s2[:, None, :, None, None], 0.0).to(dt)

    # The same-conv, taps in row-major order.
    kb_n = c // 16

    def same_window(j):
        tap, kb = divmod(j, kb_n)
        ky, kx = divmod(tap, 3)
        a = mid[:, :, 16 * kb:16 * kb + 16, ky:ky + TILE, kx:kx + TILE]
        return a.reshape(bsz, ty * tx, 16, TILE * TILE)

    y = conv_products(same_window, same_chunks, split, flush_chunks).to(dt)
    y = y.reshape(bsz, ty * tx, c, TILE, TILE)

    # Epilogue and ToRGB on the whole padded image, then cut to (h, w).
    y = y.reshape(bsz, ty, tx, c, TILE, TILE).permute(0, 3, 1, 4, 2, 5)
    y = y.reshape(bsz, c, ty * TILE, tx * TILE)
    n2p = F.pad(n2[0, 0], (0, TILE * tx - w, 0, TILE * ty - h))
    bias2 = (nw2 * n2p)[None, None] + b2[None, :, None, None]
    pre2 = (y * d2[:, :, None, None] + bias2 if exact
            else _fma(y, d2[:, :, None, None].expand_as(y), bias2.expand_as(y)))
    x2 = act(pre2)
    m = x2 * s3[:, :, None, None]
    wr = w_rgb.reshape(3, c)
    if exact:
        rgb = torch.einsum("bchw,oc->bohw", m, wr) + rgb_b[None, :, None, None]
    else:
        parts = []
        for tq in range(4):
            p = torch.zeros((bsz, 3) + m.shape[2:])
            for n in range(c // 8):
                for e in range(2):
                    co = 8 * n + 2 * tq + e
                    wco = wr[:, co][None, :, None, None].expand_as(p)
                    p = _fma(m[:, co:co + 1].expand_as(p), wco, p)
            parts.append(p)
        rgb = ((parts[0] + parts[1]) + (parts[2] + parts[3])) + rgb_b[None, :, None, None]
    rgb, x2 = rgb[:, :, :h, :w], x2[:, :, :h, :w]
    return (rgb, x2) if want_x2 else rgb


def _outs(res, want_x2):
    return res if want_x2 else (res,)


def _worst(got, ref):
    return max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))


def signed_mean_error(got, ref):
    """Mean of (got - ref) along the sign of ref, over the mean of |ref|: a
    rounding toward zero that shrinks the results makes it negative."""
    num = sum(float(((a.double() - b) * torch.sign(b)).sum()) for a, b in zip(got, ref))
    den = sum(float(b.abs().sum()) for b in ref)
    return num / den


def errors(ops, want_x2=True, split="3xtf32", flush_chunks=FLUSH_CHUNKS):
    """The emulation under ``split`` against the plain float32 section (max
    abs) and against float64 (max abs and the signed mean error)."""
    got = _outs(emulate(ops, want_x2, split, flush_chunks), want_x2)
    with torch.no_grad():
        ref32 = _outs(fused_section_plain(*ops, want_x2=want_x2), want_x2)
        ref64 = _outs(fused_section_plain(*[t.double() for t in ops], want_x2=want_x2), want_x2)
    return {"plain": _worst(got, ref32), "f64": _worst(got, ref64),
            "sme": signed_mean_error(got, ref64), "plain_f64": _worst(ref32, ref64),
            "plain_sme": signed_mean_error(ref32, ref64)}


# (seed, B, C, H, W, want_x2): both full-width sections' C with several tiles,
# C = 16, border only, ragged, odd and non-square.
CASES = [
    (6, 2, 64, 16, 16, True), (6, 2, 32, 16, 16, False), (6, 1, 16, 24, 24, True),
    (6, 3, 16, 1, 1, False), (6, 3, 64, 2, 2, True),
    (6, 2, 32, 13, 7, True), (6, 2, 64, 13, 7, False),
]


@functools.lru_cache(maxsize=None)
def case_errors(case, split="3xtf32", flush_chunks=FLUSH_CHUNKS):
    """``errors`` at one of CASES, computed once."""
    return errors(problem(*case[:5]), case[5], split, flush_chunks)


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_the_card_bound(case):
    """The shipped split and flushes hold 1e-4 against the plain float32
    section twice over, and lie no farther from float64 than 2x the plain
    section's own distance plus 1e-5."""
    res = case_errors(case)
    assert res["plain"] * MARGIN <= BOUND, res
    assert res["f64"] <= 2 * res["plain_f64"] + 1e-5, res


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (13, 7)])
def test_exact_formulation_is_the_plain_section(c, h, w, want_x2):
    """In float64 without rounding, the tiles, the 21 x 21 windows, the parity
    groups' taps, the blur and the mid tile's zeros reproduce the plain
    section to 1e-10."""
    ops = [t.double() for t in problem(3, 2, c, h, w)]
    got = _outs(emulate(ops, want_x2, split=None), want_x2)
    with torch.no_grad():
        ref = _outs(fused_section_plain(*ops, want_x2=want_x2), want_x2)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float64
    assert _worst(got, ref) <= EXACT_BOUND


@pytest.mark.parametrize("c,b,want_x2", [(64, 1, True), (32, 1, False), (16, 1, True)])
def test_emulation_matches_jax_kernel(c, b, want_x2):
    """Against the JAX Pallas section in interpret mode on the fold-x input
    (r = 16, 32, 64 output rows at C = 64, 32, 16), at the plain section's
    bound against it (3e-5 absolute and relative) plus the card's 1e-4."""
    r = 8 * 128 // c
    rng = np.random.default_rng(c)
    x = rng.standard_normal((b, r // 2, r // 2, 2 * c)).astype(np.float32)
    args = section_arrays(c + 1, c, b, r)
    ref = jax_section(x, args, want_x2)
    ops = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())] + to_port(args)
    got = _outs(emulate(ops, want_x2), want_x2)
    for a, want in zip(got, ref[:2 if want_x2 else 1]):
        np.testing.assert_allclose(a.numpy(), want, atol=3e-5 + BOUND, rtol=3e-5)


def test_flush_interval():
    """The interval is the longest that keeps the emulation within 1.5x the
    plain float32 section's own distance from float64 at every case (plus
    1e-7, half a float32 ulp of the outputs): flushing every 2 chunks (4 k8
    steps, chains of 12 products) does, every 4 does not at C = 64."""
    def holds(res):
        return res["f64"] <= 1.5 * res["plain_f64"] + 1e-7

    for case in CASES:
        assert holds(case_errors(case)), case
    longer = case_errors(CASES[0], flush_chunks=2 * FLUSH_CHUNKS)
    assert not holds(longer), longer


def test_signed_mean_error_is_small():
    """At both full-width sections' C the flushed split shrinks the outputs
    by less than SME_BOUND / 2 of their mean magnitude (the card tests hold
    SME_BOUND); one chain a parity group without flushes shrinks them by more
    than SME_BOUND / 2 at C = 64."""
    for case in CASES[:2]:   # C = 64 with x2, C = 32 without
        res = case_errors(case)
        assert abs(res["sme"]) * MARGIN <= SME_BOUND, res
    chain = case_errors(CASES[0], flush_chunks=None)
    assert chain["sme"] < -SME_BOUND / MARGIN, chain


def test_one_tf32_product_breaks_the_bound():
    """A single TF32 product keeps 10 mantissa bits: at C = 64 (16 x 16 ->
    32 x 32, x2 written) it misses 1e-4 against the plain section."""
    res = case_errors(CASES[0], split="tf32")
    assert res["plain"] > BOUND, res


def test_one_chain_a_group_keeps_its_margin():
    """Without flushes (one chain of mma.sync over each parity group's and the
    same-conv's whole K, up to 3 x 64 and 3 x 72 products at C = 64) the
    rounding toward zero stays inside 1e-4 at these shapes, by a margin of
    about 4x (2.34e-5 at C = 64, 16 x 16 -> 32 x 32), about ten times the
    flushed split's error: it is the bias (test_signed_mean_error_is_small),
    not the bound, that the flushes are for."""
    res = case_errors(CASES[0], flush_chunks=None)
    shipped = case_errors(CASES[0])
    assert 4 * res["plain"] <= BOUND and res["plain"] > 5 * shipped["plain"], (res, shipped)


def test_records_hold_the_split_weights():
    """The wrapper's records: hi and lo are TF32, hi + lo is each raw weight
    to 2^-21 of it, and hi is the weight rounded to TF32."""
    ops = problem(2, 1, 32, 4, 4)
    wu, ws, wr = sg2_tail_cuda.kernel_weights(ops[1], ops[2], ops[3], torch.float32)
    assert tuple(wu.shape) == (9 * 64 // 16, 2, 4, 32, 4)
    assert tuple(ws.shape) == (9 * 32 // 16, 2, 4, 32, 4)
    for rec in (wu, ws):
        assert not bool((rec.view(torch.int32) & 0x1FFF).any())
    hi, lo = _decode(wu, 32)
    raw = _raw_chunks(torch.stack([ops[1][:, :, ky, kx]
                                   for ky, kx in sg2_tail_cuda.UP_TAP_ORDER]), 64)
    assert float(((hi + lo) - raw).abs().max()) <= 2.0 ** -21 * float(raw.abs().max())
    assert torch.equal(hi.float(), tf32(raw.float()))


def _report():
    for seed, b, c, h, w, want_x2 in CASES:
        ops = problem(seed, b, c, h, w)
        for split, flush in (("3xtf32", 1), ("3xtf32", 2), ("3xtf32", 4),
                             ("3xtf32", None), ("tf32", FLUSH_CHUNKS)):
            res = errors(ops, want_x2, split, flush)
            print(f"{split} flush every {flush} chunk(s), B={b} C={c} {h}x{w}"
                  f"{' +x2' if want_x2 else ''}: vs plain f32 {res['plain']:.3g}, vs float64 "
                  f"{res['f64']:.3g}, signed mean error {res['sme']:.3g} (plain f32 vs float64 "
                  f"{res['plain_f64']:.3g}, signed {res['plain_sme']:.3g})")


if __name__ == "__main__":
    _report()
