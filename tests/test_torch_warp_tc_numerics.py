"""Where the tensor-core warp kernel rounds, emulated on the CPU.

``warpedganspace_torch/csrc/rbf_warp.cu`` runs both contractions of the warp
on the tensor cores with bf16 operands and float32 accumulation, in split
precision: a float32 operand x is carried as hi = bf16(x) and
lo = bf16(x - hi), and a product keeps every piece pair but lo * lo.

- pass 1, S = z sv^T: z as hi + lo; bf16 sets are exact in bf16 (2 products),
  float32 sets are split too (3 products: z_hi sv_hi, z_lo sv_hi, z_hi sv_lo);
- the weights w = ag exp(-g (|z|^2 - 2 S + |sv|^2)) and their row sums stay
  float32;
- pass 2, acc += w sv: w as hi + lo (2 products with bf16 sets, 3 with
  float32 ones);
- the sets are walked in chunks of ``rbf_cuda.CHUNK`` vectors; each of the
  plan's splits of 2N sums its own chunks, and the splits' partial sums are
  added in order before -2 (sum w) z + 2 acc is normalised.

The emulation below follows those rounding points in float32 arithmetic. It
lives in this file only, on no path of the package. It is held to the plain
float32 version (``rbf_cuda._torch_kn``) at the card's bound of 1e-4 max abs
on unit directions, to a float64 evaluation of the same formula, and, at the
small shapes of ``tests/test_torch_rbf.py``, to the JAX package's fused
kernel in interpret mode. bf16 set storage is held to float32 sets at a mean
cosine above 0.999 (the bound of ``tests/test_rbf_pallas.py``). The shapes
are those the kernel runs (K, 2N, d, R): 200, 1024, 512 at R = 64, 16, 12 and
2, and BigGAN's 120, 512, 120 at R = 8, each on a subset of the K sets
(the sets are independent, and their radii span [1, 4) as in
``SupportSets``), with gamma 1/d and 8/d and with codes scaled as W-space
codes may be. The tests also check the launch plan the wrapper computes on
the host. The inputs are made with numpy from fixed seeds.

    PYTHONPATH=. python tests/test_torch_warp_tc_numerics.py   # prints the worst errors
"""
import math

import jax  # noqa: F401  (the JAX package's kernel runs in interpret mode on the CPU)
import numpy as np
import pytest
import torch

from warpedganspace_tpu.ops import rbf_pallas as jrbf_pallas
from warpedganspace_torch.ops import rbf_cuda
from warpedganspace_torch.ops.rbf_cuda import CHUNK, Plan, plan

torch.set_num_threads(1)

BOUND = 1e-4         # max abs on unit directions, as chip_smoke.py and the card tests
COS_BOUND = 0.999    # bf16 set storage against float32 sets

# (K, 2N, d, R) of the kernel's shapes, and how many of the K sets a test takes.
TABLE = [(200, 1024, 512, 64), (200, 1024, 512, 16), (200, 1024, 512, 12),
         (200, 1024, 512, 2), (120, 512, 120, 8)]
SUBSET = 6
# (gamma as a multiple of 1/d, scale of the codes): Z-space codes and the
# init's gamma, a gamma eight times larger, and codes a quarter and four times
# the size of Z-space ones (W-space codes differ in scale from z).
REGIMES = [(1.0, 1.0), (8.0, 1.0), (1.0, 0.25), (1.0, 4.0)]


def _slots(tile_rows):
    """An H100's 132 SMs, one block of 32 rows or two of 16 on each."""
    return 132 if tile_rows == 32 else 264


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def emulate(sv, g, ag, svsq, z, p: Plan):
    """The kernel's arithmetic on the packed layout: (K, R, d) float32 directions."""
    k, n2, d = sv.shape
    rows = z.shape[1]
    f32_sets = sv.dtype == torch.float32
    sv_hi, sv_lo = _split(sv.float()) if f32_sets else (sv.float(), None)
    z_hi, z_lo = _split(z)
    zsq = torch.sum(z * z, dim=-1, keepdim=True)
    span = p.chunks_per_split * CHUNK
    acc = torch.zeros((k, rows, d))
    wsum = torch.zeros((k, rows, 1))
    for s in range(p.splits):
        acc_s = torch.zeros((k, rows, d))
        wsum_s = torch.zeros((k, rows, 1))
        for j0 in range(s * span, min(n2, (s + 1) * span), CHUNK):
            j1 = min(n2, j0 + CHUNK)
            b_hi = sv_hi[:, j0:j1]
            cross = torch.bmm(z_lo, b_hi.transpose(1, 2)) + torch.bmm(z_hi, b_hi.transpose(1, 2))
            if f32_sets:
                cross = cross + torch.bmm(z_hi, sv_lo[:, j0:j1].transpose(1, 2))
            w = ag[:, None, j0:j1] * torch.exp(
                -g[:, None, j0:j1] * (zsq - 2.0 * cross + svsq[:, None, j0:j1]))
            wsum_s = wsum_s + w.sum(-1, keepdim=True)
            w_hi, w_lo = _split(w)
            acc_s = acc_s + torch.bmm(w_lo, b_hi) + torch.bmm(w_hi, b_hi)
            if f32_sets:
                acc_s = acc_s + torch.bmm(w_hi, sv_lo[:, j0:j1])
        acc, wsum = acc + acc_s, wsum + wsum_s
    grad = -2.0 * wsum * z + 2.0 * acc
    return grad * torch.rsqrt(torch.sum(grad * grad, dim=-1, keepdim=True))


def _float64(sv, g, ag, svsq, z):
    """The plain formula in float64 (the plain version itself computes in float32)."""
    sv, g, ag, svsq, z = (t.double() for t in (sv, g, ag, svsq, z))
    zsq = torch.sum(z * z, dim=-1, keepdim=True)
    w = ag[:, None] * torch.exp(-g[:, None] * (zsq - 2.0 * torch.bmm(z, sv.transpose(1, 2))
                                               + svsq[:, None]))
    grad = -2.0 * w.sum(-1, keepdim=True) * z + 2.0 * torch.bmm(w, sv)
    return grad * torch.rsqrt(torch.sum(grad * grad, dim=-1, keepdim=True))


def _sets(k_total, n2, d, idx, gamma_mult, seed):
    """Sets ``idx`` of a K-set init (dipoles, radii 1 + 3k/K), as (sv, a, g) float32."""
    rng = np.random.default_rng(seed)
    half = rng.standard_normal((len(idx), n2 // 2, d))
    sv = np.stack([half, -half], axis=2).reshape(len(idx), n2, d)
    radii = 1.0 + 3.0 / k_total * np.asarray(idx, np.float64)
    sv = radii[:, None, None] * sv / np.linalg.norm(sv, axis=-1, keepdims=True)
    a = np.tile(np.array([1.0, -1.0]), (len(idx), n2 // 2))
    g = np.full((len(idx), n2), gamma_mult / d)
    return tuple(torch.from_numpy(x.astype(np.float32)) for x in (sv, a, g))


def table_errors(shape, gamma_mult=1.0, z_scale=1.0, subset=SUBSET, seed=0):
    """Worst errors of the emulation at one shape of the table (a subset of its sets)."""
    k_total, n2, d, rows = shape
    idx = np.linspace(0, k_total - 1, subset).round().astype(int)
    sv, a, g = _sets(k_total, n2, d, idx, gamma_mult, seed)
    z = torch.from_numpy(
        (z_scale * np.random.default_rng(seed + 1).standard_normal((subset, rows, d)))
        .astype(np.float32))
    p = plan(k_total, n2, rows, d, _slots)
    out = {}
    ws = rbf_cuda.prepare_warp_sets(sv, a, g)
    ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
    ref64 = _float64(ws.sv, ws.g, ws.ag, ws.svsq, z)
    got = emulate(ws.sv, ws.g, ws.ag, ws.svsq, z, p)
    out["f32 sets vs plain"] = float((got - ref).abs().max())
    out["f32 sets vs float64"] = float((got.double() - ref64).abs().max())
    out["plain vs float64"] = float((ref.double() - ref64).abs().max())
    ws16 = rbf_cuda.prepare_warp_sets(sv, a, g, torch.bfloat16)
    ref16 = rbf_cuda._torch_kn(ws16.sv, ws16.g, ws16.ag, ws16.svsq, z)
    got16 = emulate(ws16.sv, ws16.g, ws16.ag, ws16.svsq, z,
                    plan(k_total, n2, rows, d, _slots, elem=2))
    out["bf16 sets vs plain"] = float((got16 - ref16).abs().max())
    out["bf16 vs f32 sets, mean cosine"] = float((got16 * got).sum(-1).mean())
    return out


def _check(errs):
    assert errs["f32 sets vs plain"] <= BOUND
    assert errs["f32 sets vs float64"] <= BOUND
    assert errs["bf16 sets vs plain"] <= BOUND
    assert errs["bf16 vs f32 sets, mean cosine"] > COS_BOUND


@pytest.mark.parametrize("shape", TABLE, ids=lambda s: "K{}-2N{}-d{}-R{}".format(*s))
def test_table_shapes(shape):
    _check(table_errors(shape))


@pytest.mark.parametrize("gamma_mult,z_scale", REGIMES[1:])
@pytest.mark.parametrize("shape", [TABLE[0], TABLE[3], TABLE[4]],
                         ids=lambda s: "K{}-2N{}-d{}-R{}".format(*s))
def test_gammas_and_code_scales(shape, gamma_mult, z_scale):
    _check(table_errors(shape, gamma_mult, z_scale, subset=3, seed=5))


def _problem(seed, k, two_n, d, n):
    """The problems of tests/test_torch_rbf.py: (sv, a, g, z (N, K, d))."""
    rng = np.random.default_rng(seed)
    sv = rng.standard_normal((k, two_n, d)).astype(np.float32)
    a = rng.standard_normal((k, two_n)).astype(np.float32)
    g = (np.abs(rng.standard_normal((k, two_n))) * 0.3).astype(np.float32)
    z = rng.standard_normal((n, k, d)).astype(np.float32)
    return sv, a, g, z


@pytest.mark.parametrize("k,two_n,d,n", [(5, 6, 7, 3), (8, 256, 128, 16), (4, 130, 120, 9),
                                         (3, 40, 16, 40)])
@pytest.mark.parametrize("splits", [1, 3])
def test_matches_jax_pallas(k, two_n, d, n, splits):
    """The emulation against the JAX fused kernel (interpret mode), with the
    2N axis in one run and in runs of whole chunks."""
    sv, a, g, z = _problem(0, k, two_n, d, n)
    ref = np.asarray(jrbf_pallas.warp_grad_all_sets_fused(sv, a, g, z))
    chunks = math.ceil(two_n / CHUNK)
    per = math.ceil(chunks / splits)
    p = Plan(16 if n <= 16 else 32, 1, math.ceil(chunks / per), per)
    t = [torch.from_numpy(x) for x in (sv, a, g)]
    ws = rbf_cuda.prepare_warp_sets(*t)
    got = emulate(ws.sv, ws.g, ws.ag, ws.svsq, torch.from_numpy(z).transpose(0, 1).contiguous(), p)
    assert float(np.abs(got.transpose(0, 1).numpy() - ref).max()) <= BOUND


def test_bf16_sets_match_jax_pallas():
    """bf16 set storage against the JAX kernel's bf16 storage: the JAX kernel
    also rounds z and the weights to bf16 for its MXU products, the port
    carries them as hi + lo, so the bound is the bf16-storage one."""
    sv, a, g, z = _problem(7, 6, 16, 40, 5)
    zkn = np.ascontiguousarray(np.transpose(z, (1, 0, 2)))
    ref = np.asarray(jrbf_pallas.warp_grad_all_sets_kn(
        jrbf_pallas.prepare_warp_sets(sv, a, g, dtype=jax.numpy.bfloat16), zkn))
    ws = rbf_cuda.prepare_warp_sets(*(torch.from_numpy(x) for x in (sv, a, g)), torch.bfloat16)
    got = emulate(ws.sv, ws.g, ws.ag, ws.svsq, torch.from_numpy(zkn), Plan(16, 1, 1, 1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.02)
    assert np.mean(np.sum(got * ref, axis=-1)) > COS_BOUND


@pytest.mark.parametrize("k,n2,rows,d", [(200, 1024, 64, 512), (200, 1024, 2, 512),
                                         (120, 512, 8, 120), (1, 1000, 65, 500), (1, 6, 1, 7),
                                         (200, 1024, 17, 512), (3, 0, 4, 8)])
@pytest.mark.parametrize("elem", [4, 2])
def test_plan_covers_every_chunk_once(k, n2, rows, d, elem):
    p = plan(k, n2, rows, d, _slots, elem)
    chunks = max(1, math.ceil(n2 / CHUNK))
    assert p.tile_rows in rbf_cuda.TILE_ROWS and p.tile_rows >= min(rows, 16)
    assert p.row_tiles * p.tile_rows >= rows > (p.row_tiles - 1) * p.tile_rows
    # Every chunk in exactly one run; no run empty.
    assert 1 <= p.splits <= rbf_cuda.MAX_SPLITS
    assert (p.splits - 1) * p.chunks_per_split < chunks <= p.splits * p.chunks_per_split
    assert p.scratch_floats(k, rows, d) == p.splits * k * rows * (d + 1)


def test_plan_fills_the_card_at_small_rows():
    # 200 sets of two rows on 132 SMs: whole-2N blocks would take two waves
    # for 1.5 waves of work; the plan splits 2N.
    assert plan(200, 1024, 2, 512, _slots).splits > 1
    # One set: splits up to the maximum, so more than one SM works.
    assert plan(1, 1024, 2, 512, _slots).splits == rbf_cuda.MAX_SPLITS
    # Enough blocks of whole sets already: R=16 at K=200 is one wave.
    assert plan(200, 1024, 16, 512, _slots).splits == 1


def test_split_runs_agree():
    """The same call cut into 1, 2 and 5 runs of 2N agrees within the bound,
    and one plan repeated gives the same bits."""
    k_total, n2, d, rows = 4, 160, 64, 3
    sv, a, g = _sets(k_total, n2, d, list(range(k_total)), 1.0, 3)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((k_total, rows, d))
                         .astype(np.float32))
    ws = rbf_cuda.prepare_warp_sets(sv, a, g)
    outs = [emulate(ws.sv, ws.g, ws.ag, ws.svsq, z, Plan(16, 1, s, per))
            for s, per in ((1, 10), (2, 5), (5, 2))]
    for o in outs[1:]:
        assert float((o - outs[0]).abs().max()) <= BOUND
    again = emulate(ws.sv, ws.g, ws.ag, ws.svsq, z, Plan(16, 1, 5, 2))
    assert torch.equal(again, outs[2])


if __name__ == "__main__":
    for shape in TABLE:
        for gm, zs in REGIMES:
            errs = table_errors(shape, gm, zs)
            print(f"K={shape[0]} 2N={shape[1]} d={shape[2]} R={shape[3]} gamma={gm:g}/d "
                  f"z x{zs:g}: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
