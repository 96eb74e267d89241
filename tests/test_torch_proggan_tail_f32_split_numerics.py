"""Where the float32 tensor-core ProgGAN tail kernel rounds, emulated on the CPU.

The float32 design of ``warpedganspace_torch/csrc/proggan_tail.cu``
(``namespace tf``) computes one tail section per 16 x 16 output tile:

- the input tile of 10 x 10 pixels from (y0 / 2 - 1, x0 / 2 - 1), zero
  outside the image, PixelNormed over its 2C channels in float32 and carried
  as TF32 hi + lo;
- the nearest-up conv as four parity groups of 9 x 9 mid positions (A, V):
  mid pixel (2A + pi, 2V + pj) of the 18 x 18 mid tile from (y0 - 1, x0 - 1)
  is a 2 x 2 conv of input pixels (A + a, V + b) with the merged taps
  ``merge_up_taps(w_up)[pi][pj][a][b]``, summed in float32; the four parities
  share the A operand, taps (a, b) in row-major order;
- fmaf(sum, s_up, b_up), LeakyReLU, then PixelNorm over the C channels of
  each mid pixel, the normalised mid tile carried as TF32 hi + lo, zero at
  mid pixels outside the image;
- the same-conv of the mid tile, taps (ky, kx) in row-major order, then
  fmaf(sum, s_same, b_same) and LeakyReLU; with the RGB head, PixelNorm over
  the C channels and the 1x1 conv as four lanes' partials over channels
  2 tq, 2 tq + 1 of each n8 tile, added as (p0 + p1) + (p2 + p3), then
  fmaf(rgb inv, s_head, b_head).

Both convolutions run on the tensor cores in split precision (3xTF32,
``tests/split_precision.py``): each weight chunk (one tap x 16 input
channels, two k8 steps) is a ``mma.sync`` m16n8k8 per k8 step and pair of
pieces, lo hi, hi lo, hi hi, each adding its exact products into a float32
accumulator and rounding toward zero; every ``FLUSH_STEPS`` k8 steps the
accumulator is added into a float32 sum, rounded to nearest, and starts
again from 0. The weights' pieces are read from the records
:func:`~warpedganspace_torch.ops.proggan_tail_cuda.f32_records` gives the
kernel, at the kernel's indices, so the emulation checks their layout too.

The emulation lives in this file only, on no path of the package. It is held
to the plain float32 section within the card tests' 1e-4, to the JAX
package's Pallas ``fused_section`` run in interpret mode as
``tests/test_torch_proggan_tail.py`` runs it, and, in float64 without
rounding (raw weights merged in float64, no pieces), to the plain section in
float64 within 1e-10 at ragged shapes: that checks the index arithmetic of
the tiles, parities, merged taps and the mid tile's zeros. One TF32 product
(hi only) and longer chains of products are emulated beside it. The signed
mean error (the error along the reference's sign, over its mean magnitude)
against float64 is the card tests' bias check. Operands follow
``chip_smoke.py::tail_problem``'s recipe, made with numpy from fixed seeds.

    PYTHONPATH=. python tests/test_torch_proggan_tail_f32_split_numerics.py   # prints the errors
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.split_precision import round_toward_zero, split_pieces, tf32
from tests.test_torch_proggan_tail import section_arrays, to_port
from warpedganspace_tpu.ops import proggan_tail_pallas as ptp
from warpedganspace_torch.ops import proggan_tail_cuda
from warpedganspace_torch.ops.proggan_tail import fused_section_plain

torch.set_num_threads(1)

TILE, MID, GROUP, IN_WIN = 16, 18, 9, 10
CHUNK_STEPS = 2           # k8 steps (16 input channels) of a weight chunk
FLUSH_STEPS = 2           # kFlushSteps of csrc/proggan_tail.cu: chains of 6 products
BOUND = 1e-4              # the card tests' float32 bound against the plain section
EXACT_BOUND = 1e-10       # float64 without rounding against the plain section in float64
MARGIN = 2.0              # the shipped split must hold BOUND this many times over
SME_BOUND = 1e-6          # the card tests' bound on the signed mean error against float64
SLOPE = float(np.float32(0.2))
EPS = 1e-8
# The pairs of pieces of a k8 step, in the kernel's order (tc_tf32.cuh's
# mma3_records): (A piece, B piece), 0 = hi, 1 = lo.
PAIRS = {"3xtf32": ((1, 0), (0, 1), (0, 0)), "tf32": ((0, 0),)}


def problem(seed, b, c, h, w, head):
    """``chip_smoke.py::tail_problem``'s recipe from numpy: unit-scale input,
    weights that keep every conv output at unit scale, WScale scales != 1
    and random biases. Returns (operands, head or None)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))

    ops = [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3, std=(18 * c) ** -0.5), rnd(c, std=0.3),
           torch.tensor([1.3]), rnd(c, c, 3, 3, std=(9 * c) ** -0.5), rnd(c, std=0.3),
           torch.tensor([0.8])]
    hd = (rnd(3, c, 1, 1, std=c ** -0.5), rnd(3, std=0.3), torch.tensor([1.1])) if head else None
    return ops, hd


def merged64(w_up):
    """The merged up-conv taps in float64, (4 taps (a, b), 4 parities (pi, pj),
    C, 2C), from their definition: along one axis, parity 0 (an odd image row)
    reads input offset 0 with taps 0 + 1 and offset 1 with tap 2, parity 1
    (an even row) offset 0 with tap 0 and offset 1 with taps 1 + 2."""
    groups = {(0, 0): (0, 1), (0, 1): (2,), (1, 0): (0,), (1, 1): (1, 2)}   # (parity, offset)
    w = w_up.double()
    out = torch.zeros((4, 4) + w.shape[:2], dtype=torch.float64)
    for a in range(2):
        for b in range(2):
            for pi in range(2):
                for pj in range(2):
                    for ky in groups[(pi, a)]:
                        for kx in groups[(pj, b)]:
                            out[2 * a + b, 2 * pi + pj] += w[:, :, ky, kx]
    return out


def _decode(records, n_out):
    """The kernel's view of split records (chunks, 2, N/8, 32, 4): (hi, lo),
    each (chunks, 2 k8 steps, 8 k, N) float64 -- lane 4 gq + tq holds
    {hi b0, hi b1, lo b0, lo b1} of (k tq, n gq) and (k tq + 4, n gq)."""
    r = records.double().reshape(records.shape[0], 2, n_out // 8, 8, 4, 2, 2)
    r = r.permute(5, 0, 1, 6, 4, 2, 3)
    return r.reshape(2, records.shape[0], 2, 8, n_out)


def _raw_chunks(taps, ci_n):
    """Raw float64 weights as chunks: (taps x ci / 16, 2, 8, N) from
    (taps, N, C in)."""
    t, n, _ = taps.shape
    return taps.double().permute(0, 2, 1).reshape(t * (ci_n // 16), 2, 8, n)


def _fma(a, b, c):
    """fmaf in float32: a b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _leaky(v):
    return torch.where(v >= 0, v, (0.2 if v.dtype == torch.float64 else SLOPE) * v)


def conv_tiles(windows, chunks, split, flush_steps, n_tiles, block=32):
    """:func:`conv_products` over blocks of ``block`` tiles at a time (the
    tiles are independent; a block's sums stay in the CPU's caches):
    ``windows(j, tiles)`` is the A window of chunk j at a slice of the tiles,
    (B, tiles, 16, P); returns (B, n_tiles, N, P)."""
    return torch.cat([conv_products(lambda j, sl=slice(t, t + block): windows(j, sl), chunks,
                                    split, flush_steps)
                      for t in range(0, n_tiles, block)], dim=1)


def conv_products(windows, chunks, split, flush_steps):
    """The implicit GEMM's products over the chunks of one accumulator, as
    the kernel chains them: the sum over chunks j of the A window
    ``windows(j)`` (..., 16, P) times B chunk j, (..., N, P). ``split=None``:
    ``chunks`` are float64 weights (2, 8, N) and the sum is exact; else they
    are (hi, lo) pairs and each k8 step is a mma.sync per pair of pieces,
    rounding toward zero, added into a float32 sum every ``flush_steps`` k8
    steps (None: one chain)."""
    if split is None:
        total = 0.0
        for j, wb in enumerate(chunks):
            total = total + torch.einsum("...kp,kn->...np", windows(j).double(),
                                         wb.reshape(16, -1))
        return total
    acc = total = None   # acc: float64 holding float32 values; total: float32
    since = 0
    for j, pb in enumerate(chunks):
        pa = [p.double() for p in split_pieces(windows(j), split)]
        for s in range(CHUNK_STEPS):
            ks = slice(8 * s, 8 * s + 8)
            for ia, ib in PAIRS[split]:
                prod = torch.einsum("...kp,kn->...np", pa[ia][..., ks, :], pb[ib][s])
                acc = truncate_to_f32(prod if acc is None else acc.add_(prod))
            since += 1
            if flush_steps is not None and since == flush_steps:
                total = acc.float() if total is None else total + acc.float()
                acc, since = None, 0
    if acc is not None:
        total = acc.float() if total is None else total + acc.float()
    return total


def truncate_to_f32(x):
    """float64 to float32 values rounded toward zero, as the tensor cores
    round their float32 sums (``tests/split_precision.py::round_toward_zero``
    for values in float32's normal range), in place in float64: the 29 low
    bits of the float64 significand cleared."""
    x.view(torch.int64).bitwise_and_(~((1 << 29) - 1))
    return x


def emulate(ops, head=None, split="3xtf32", flush_steps=FLUSH_STEPS):
    """The float32 kernel's arithmetic on one section's operands under
    ``split``; ``split=None`` runs the same tiles, parities and taps in
    float64 without rounding."""
    exact = split is None
    dt = torch.float64 if exact else torch.float32
    x, w_up, b_up, s_up, w_same, b_same, s_same = [t.to(dt) for t in ops]
    bsz, ci, hi, wi = x.shape
    c = ci // 2
    h, w = 2 * hi, 2 * wi
    ty, tx = -(-h // TILE), -(-w // TILE)
    nt = ty * tx

    def fma(a, b, cc):
        return a * b + cc if exact else _fma(a, b, cc)

    def pixel_norm(v, n):   # over dim 2 (channels) of (B, tiles, ch, ...)
        return torch.rsqrt((v * v).sum(dim=2, keepdim=True) / n + EPS)

    if exact:
        up_chunks = list(_raw_chunks(merged64(w_up).reshape(4, 4 * c, ci), ci))
        same_chunks = list(_raw_chunks(w_same.permute(2, 3, 0, 1).reshape(9, c, c), c))
    else:
        up_rec, same_rec = proggan_tail_cuda.f32_records(ops[1], ops[4])
        up_chunks = list(zip(*_decode(up_rec, 4 * c)))
        same_chunks = list(zip(*_decode(same_rec, c)))

    # Input tiles, zero outside the image, PixelNormed: (B, tiles, 2C, 10, 10).
    xp = F.pad(x, (1, 8 * tx + 1 - wi, 1, 8 * ty + 1 - hi))
    tiles = xp.unfold(2, IN_WIN, 8).unfold(3, IN_WIN, 8)              # B, 2C, ty, tx, 10, 10
    tiles = tiles.permute(0, 2, 3, 1, 4, 5).reshape(bsz, nt, ci, IN_WIN, IN_WIN)
    tiles = tiles * pixel_norm(tiles, ci)

    # The up-conv: one GEMM of the 81 positions by the four parities' C
    # columns (parity-major), K = taps (a, b) x 2C.
    kb_n = ci // 16

    def window(j, sl):
        t, kb = divmod(j, kb_n)
        a, b = divmod(t, 2)
        win = tiles[:, sl, 16 * kb:16 * kb + 16, a:a + GROUP, b:b + GROUP]
        return win.reshape(bsz, -1, 16, GROUP * GROUP)

    up = conv_tiles(window, up_chunks, split, flush_steps, nt).to(dt)   # B, tiles, 4C, 81
    up = up.reshape(bsz, nt, 2, 2, c, GROUP, GROUP)
    pre = torch.zeros((bsz, nt, c, MID, MID), dtype=dt)
    for pi in range(2):
        for pj in range(2):
            pre[..., pi::2, pj::2] = up[:, :, pi, pj]
    v = _leaky(fma(pre, s_up.expand_as(pre), b_up[:, None, None].expand_as(pre)))
    gy = TILE * torch.arange(ty)[:, None] - 1 + torch.arange(MID)[None, :]   # ty, 18
    gx = TILE * torch.arange(tx)[:, None] - 1 + torch.arange(MID)[None, :]   # tx, 18
    inside = (((gy >= 0) & (gy < h))[:, None, :, None]
              & ((gx >= 0) & (gx < w))[None, :, None, :]).reshape(nt, 1, MID, MID)
    mid = torch.where(inside[None], v * pixel_norm(v, c), 0.0).to(dt)

    # The same-conv, taps in row-major order.
    kb_n = c // 16

    def same_window(j, sl):
        tap, kb = divmod(j, kb_n)
        ky, kx = divmod(tap, 3)
        win = mid[:, sl, 16 * kb:16 * kb + 16, ky:ky + TILE, kx:kx + TILE]
        return win.reshape(bsz, -1, 16, TILE * TILE)

    y = conv_tiles(same_window, same_chunks, split, flush_steps, nt).to(dt)
    y = y.reshape(bsz, ty, tx, c, TILE, TILE).permute(0, 3, 1, 4, 2, 5)
    y = y.reshape(bsz, c, ty * TILE, tx * TILE)
    v = _leaky(fma(y, s_same.expand_as(y), b_same[:, None, None].expand_as(y)))
    if head is None:
        return v[:, :, :h, :w]
    w_out, b_out, s_out = [t.to(dt) for t in head]
    inv = torch.rsqrt((v * v).sum(dim=1, keepdim=True) / c + EPS)
    wh = w_out.reshape(3, c)
    if exact:
        rgb = torch.einsum("bchw,oc->bohw", v, wh)
    else:
        parts = []
        for tq in range(4):
            p = torch.zeros((bsz, 3) + v.shape[2:])
            for n in range(c // 8):
                for e in range(2):
                    co = 8 * n + 2 * tq + e
                    p = _fma(v[:, co:co + 1].expand_as(p), wh[:, co][None, :, None, None]
                             .expand_as(p), p)
            parts.append(p)
        rgb = (parts[0] + parts[1]) + (parts[2] + parts[3])
    out = fma(rgb * inv, s_out.expand_as(rgb), b_out[:, None, None].expand_as(rgb))
    return out[:, :, :h, :w]


def signed_mean_error(got, ref):
    """Mean of (got - ref) along the sign of ref, over the mean of |ref|: a
    rounding toward zero that shrinks the results makes it negative."""
    return float(((got.double() - ref) * torch.sign(ref)).sum()) / float(ref.abs().sum())


def errors(ops, head, split="3xtf32", flush_steps=FLUSH_STEPS):
    """The emulation under ``split`` against the plain float32 section (max
    abs) and against float64 (max abs and the signed mean error)."""
    got = emulate(ops, head, split, flush_steps)
    with torch.no_grad():
        ref32 = fused_section_plain(*ops, head=head)
        ref64 = fused_section_plain(*[t.double() for t in ops],
                                    head=None if head is None else [t.double() for t in head])

    def worst(a, b):
        return float((a.double() - b.double()).abs().max())

    return {"plain": worst(got, ref32), "f64": worst(got, ref64),
            "sme": signed_mean_error(got, ref64), "plain_f64": worst(ref32, ref64),
            "plain_sme": signed_mean_error(ref32, ref64)}


# (seed, B, C, H, W, head): the three full-width sections' C with several
# tiles (C = 16 with the head, as the 1024^2 section), border only, ragged,
# odd and non-square.
CASES = [
    (6, 2, 64, 16, 16, False), (6, 2, 32, 16, 16, False), (6, 1, 16, 24, 24, True),
    (6, 3, 16, 1, 1, True), (6, 3, 64, 2, 2, False),
    (6, 2, 32, 13, 7, True), (6, 2, 64, 13, 7, False),
]
# The whole 1024^2 section with the RGB head (32 -> 16 channels, 512^2 ->
# 1024^2), one image: the widest grid of tiles, the head's PixelNorm over 16
# small channels.
FULL_HEAD = (7, 1, 16, 512, 512, True)


@functools.lru_cache(maxsize=None)
def case_errors(case, split="3xtf32", flush_steps=FLUSH_STEPS):
    """``errors`` at one case, computed once."""
    ops, hd = problem(*case)
    return errors(ops, hd, split, flush_steps)


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_the_card_bound(case):
    """The shipped split and flushes hold 1e-4 against the plain float32
    section twice over, and lie no farther from float64 than 2x the plain
    section's own distance plus 1e-5."""
    res = case_errors(case)
    assert res["plain"] * MARGIN <= BOUND, res
    assert res["f64"] <= 2 * res["plain_f64"] + 1e-5, res


def test_full_1024_head_section():
    """The whole 1024^2 section with the head: the shipped split holds 1e-4
    against the plain section twice over, lies within 1.5x the plain
    section's distance from float64 (plus 1e-7), and its signed mean error
    against float64 stays within SME_BOUND / 2."""
    res = case_errors(FULL_HEAD)
    assert res["plain"] * MARGIN <= BOUND, res
    assert res["f64"] <= 1.5 * res["plain_f64"] + 1e-7, res
    assert abs(res["sme"]) * MARGIN <= SME_BOUND, res


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (13, 7)])
def test_exact_formulation_is_the_plain_section(c, h, w, head):
    """In float64 without rounding, the tiles, the parity groups' merged taps,
    the mid tile's zeros and the head reproduce the plain section to 1e-10."""
    ops, hd = problem(3, 2, c, h, w, head)
    ops = [t.double() for t in ops]
    hd = None if hd is None else [t.double() for t in hd]
    got = emulate(ops, hd, split=None)
    with torch.no_grad():
        ref = fused_section_plain(*ops, head=hd)
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert float((got - ref).abs().max()) <= EXACT_BOUND


@pytest.mark.parametrize("c,head", [(64, False), (16, True)])
def test_emulation_matches_jax_kernel(c, head):
    """Against the JAX Pallas section in interpret mode on the fold-x input
    (as tests/test_torch_proggan_tail.py runs it), at the plain section's
    bound against it (2e-5 absolute and relative) plus the card's 1e-4."""
    args, h = section_arrays(c, c, head)
    w = 8 * (64 // c)                       # the TPU kernel wants a folded width of 8
    x = np.random.default_rng(c + 1).standard_normal((2, 8, w, 2 * c)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(ptp.unfold_x(
            ptp.fused_section(ptp.fold_x(jnp.asarray(x), 64 // c), *args, head=h), 128 // c))
    port, port_head = to_port(args, h)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = emulate([xt] + port, port_head).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 16, 2 * w, 3 if head else c)
    np.testing.assert_allclose(got, ref, atol=2e-5 + BOUND, rtol=2e-5)


def test_flush_interval():
    """The longest interval that keeps the emulation within 1.5x the plain
    float32 section's own distance from float64 at every case (plus 1e-7,
    half a float32 ulp of the outputs) is 4 k8 steps: 8 misses at C = 64, as
    does one chain over each accumulator's whole K. The design flushes every
    FLUSH_STEPS = 2 (one weight chunk: a chain's B records stay in registers
    for the chunk it spans), which holds at every case too."""
    def holds(res):
        return res["f64"] <= 1.5 * res["plain_f64"] + 1e-7

    for case in CASES:
        assert holds(case_errors(case)), case
        assert holds(case_errors(case, flush_steps=4)), case
    for longer in (8, None):
        res = case_errors(CASES[0], flush_steps=longer)
        assert not holds(res), (longer, res)


def test_signed_mean_error_is_small():
    """At the full-width sections' C the flushed split shrinks the outputs by
    less than SME_BOUND / 2 of their mean magnitude (the card tests hold
    SME_BOUND); one chain an accumulator without flushes shrinks them by
    more than the flushed split at C = 64."""
    for case in CASES[:3]:
        res = case_errors(case)
        assert abs(res["sme"]) * MARGIN <= SME_BOUND, res
    chain = case_errors(CASES[0], flush_steps=None)
    shipped = case_errors(CASES[0])
    assert chain["sme"] < shipped["sme"] < 0, (chain, shipped)


def test_one_tf32_product_breaks_the_bound():
    """A single TF32 product keeps 10 mantissa bits: it misses 1e-4 against
    the plain section at C = 64 and at the head's C = 16."""
    for case in (CASES[0], CASES[2]):
        res = case_errors(case, split="tf32")
        assert res["plain"] > BOUND, res


def test_records_hold_the_split_weights():
    """The wrapper's records: hi and lo are TF32, hi + lo is each merged tap
    (summed in float32) or raw weight to 2^-21 of the largest, at the index
    the kernel reads it from, and hi is the raw same-conv weight rounded to
    TF32."""
    (_, w_up, _, _, w_same, _, _), _ = problem(2, 1, 32, 4, 4, False)
    up, same = proggan_tail_cuda.f32_records(w_up, w_same)
    assert tuple(up.shape) == (4 * 64 // 16, 2, 4 * 32 // 8, 32, 4)
    assert tuple(same.shape) == (9 * 32 // 16, 2, 32 // 8, 32, 4)
    for rec in (up, same):
        assert not bool((rec.view(torch.int32) & 0x1FFF).any())
    raw_same = _raw_chunks(w_same.permute(2, 3, 0, 1).reshape(9, 32, 32), 32)
    for rec, raw, n in ((up, _raw_chunks(merged64(w_up).reshape(4, 128, 64), 64), 128),
                        (same, raw_same, 32)):
        hi, lo = _decode(rec, n)
        assert float(((hi + lo) - raw).abs().max()) <= 2.0 ** -21 * float(raw.abs().max())
    assert torch.equal(_decode(same, 32)[0].float(), tf32(raw_same.float()))


def test_records_are_made_once_per_weight_pair():
    """The wrapper keeps a weight pair's records while both tensors are the
    same objects, unchanged: the same records again; after an in-place change
    of either, records of the new values."""
    (_, w_up, _, _, w_same, _, _), _ = problem(4, 1, 16, 2, 2, False)
    first = proggan_tail_cuda.cached_f32_records(w_up, w_same)
    assert proggan_tail_cuda.cached_f32_records(w_up, w_same) is first
    assert proggan_tail_cuda.cached_f32_records(w_up.clone(), w_same) is not first
    with torch.no_grad():
        w_same.mul_(2.0)
    again = proggan_tail_cuda.cached_f32_records(w_up, w_same)
    assert again is not first and torch.equal(again[0], first[0])
    want = proggan_tail_cuda.f32_records(w_up, w_same)
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    assert not torch.equal(again[1], first[1])


def _report():
    for case in CASES + [FULL_HEAD]:
        ops, hd = problem(*case)
        for split, flush in (("3xtf32", 1), ("3xtf32", 2), ("3xtf32", 4), ("3xtf32", 8),
                             ("3xtf32", None), ("tf32", FLUSH_STEPS)):
            if case == FULL_HEAD and (split, flush) != ("3xtf32", FLUSH_STEPS):
                continue
            res = errors(ops, hd, split, flush)
            _, b, c, h, w, head = case
            print(f"{split} flush every {flush} k8 step(s), B={b} C={c} {h}x{w}"
                  f"{' +head' if head else ''}: vs plain f32 {res['plain']:.3g}, vs float64 "
                  f"{res['f64']:.3g}, signed mean error {res['sme']:.3g} (plain f32 vs float64 "
                  f"{res['plain_f64']:.3g}, signed {res['plain_sme']:.3g})")


if __name__ == "__main__":
    _report()
