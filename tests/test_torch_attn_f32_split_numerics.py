"""Where the float32 tensor-core attention kernels round, emulated on the CPU.

The float32 designs of ``warpedganspace_torch/csrc/sa_attention.cu`` and
``sa_attention_bwd.cu`` run every product on the tensor cores in split
precision (3xTF32): each operand x is carried as hi = tf32(x) and
lo = tf32(x - hi), both rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` does, and a product a b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 accumulation (lo lo is
dropped). The logits theta phi^T are modelled one ``mma.sync`` at a time: each
adds a k8 step's exact products of one pair of pieces into its float32
accumulator and rounds toward zero, as the tensor cores round; up to dk=32
(four k8 steps, ``kChainSteps`` of ``csrc/tc_tf32.cuh``) the steps form one
chain, above it each step's sum starts from 0 and is added into the logits in
float32, rounded to nearest. The rest is the bf16 designs' arithmetic in
float32:

- the forward streams the keys in chunks of 64 with an online softmax; its
  weights are 2^(s log2(e) - m log2(e)) against the running maximum m, the
  exponent formed by one fused multiply-add; the value product takes the
  unnormalised float32 weights (split like any operand), the accumulator is
  rescaled whenever the running maximum moves and divided by the float32 sum
  of the weights at the end; lse = m + log(l);
- the backward recomputes beta = 2^(s log2(e) - lse log2(e)) from the
  forward's row statistic, takes rowsum(dbeta * beta) as rowsum(ct * out) of
  the forward's output, and forms ds = beta (dbeta - rowsum) in float32; beta
  and ds are split like any operand (no rounding to a narrower type); at one
  key dtheta and dphi are set to 0.

The emulation lives in this file only, on no path of the package; outside the
logits it does not model the tensor cores' rounding (their products are
float32 matrix products of the pieces). It is held
against the port's plain float32 versions and against the JAX package's
``_jnp_attention`` (and its VJP) at the card tests' float32 bounds: 1e-4 max
abs for the forward (outputs of magnitude below 1), 2e-5 for lse against its
float64 value (and against the float32 logsumexp at dk <= 24; rtol 1e-6 on top
at logits near +-200), 1e-4 relative to each gradient's largest entry for the
backward. The float32 logsumexp itself lies up to 2.8e-5 from float64 at
dk=192, so above dk=24 lse is held to float64 only. The logits in one chain
over all k8 steps break the lse bound at dk=192. The same emulation with one
TF32 product (hi only) and with
bf16 hi + lo pieces (every pair but lo lo, as the warp kernel splits) shows
which gates those narrower splits break; the script also prints three bf16
pieces (six products), which hold the gates as 3xTF32 does at the same
tensor-core cost. Inputs are made with numpy from fixed seeds.

    PYTHONPATH=. python tests/test_torch_attn_f32_split_numerics.py   # prints the worst errors
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.split_precision import round_toward_zero, split_pieces, tf32
from warpedganspace_tpu.ops.attn_pallas import _jnp_attention
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

torch.set_num_threads(1)

CHUNK = 64                # keys (forward) or columns (backward) per chunk
FWD_BOUND = 1e-4          # the card tests' float32 bounds
LSE_BOUND = 2e-5
LSE_RTOL = 1e-6           # at logits near +-200, on top of LSE_BOUND
BWD_BOUND = 1e-4
MARGIN = 1.5              # the shipped split must hold each bound this many times over
CHAIN_STEPS = 4           # k8 steps the logits sum in one chain (kChainSteps)
LOG2E = float(np.float32(1.4426950408889634))

# (B, N, M, dk, dv): the card tests' shapes at small N: BigGAN-128's dk and dv,
# ragged everything, M below a chunk and past several, dk at its limit of 192,
# dv past one column tile, the ch=16 test models' dk=2.
SHAPES = [
    (2, 100, 130, 24, 96),
    (3, 5, 7, 3, 2),
    (2, 129, 65, 5, 33),
    (2, 70, 63, 20, 80),
    (1, 37, 1000, 24, 96),
    (2, 33, 200, 40, 200),
    (1, 64, 200, 192, 40),
    (2, 60, 130, 12, 48),
    (1, 100, 256, 2, 8),
]
LARGE = (2, 200, 100, 16, 32)     # with queries and keys x8: logits near +-200
ONE_KEY = (1, 64, 1, 8, 57)


def mm(a, b, split):
    """a @ b (batched) as the kernel multiplies it under ``split``: the small
    cross products first, then hi hi, into one float32 accumulator."""
    pa, pb = split_pieces(a, split), split_pieces(b, split)
    if len(pa) == 1:
        return torch.bmm(pa[0], pb[0])
    if len(pa) == 3:   # bf16x3: the six pairs whose orders sum to at most 2
        small = (torch.bmm(pa[2], pb[0]) + torch.bmm(pa[0], pb[2])) + torch.bmm(pa[1], pb[1])
        return (small + (torch.bmm(pa[1], pb[0]) + torch.bmm(pa[0], pb[1]))) + torch.bmm(pa[0], pb[0])
    return (torch.bmm(pa[1], pb[0]) + torch.bmm(pa[0], pb[1])) + torch.bmm(pa[0], pb[0])


def logits(a, b, split, chain_steps=CHAIN_STEPS):
    """a @ b^T (batched) as the kernels form the logits under ``split``: one
    ``mma.sync`` per pair of pieces and k8 step (the small pairs first), each
    adding its exact products into its accumulator and rounding toward zero;
    up to ``chain_steps`` steps one chain, above it each step's sum from 0,
    added into the logits in float32."""
    pa, pb = split_pieces(a, split), split_pieces(b, split)
    n = len(pa)
    pairs = sorted(((i, j) for i in range(n) for j in range(n) if i + j < n),
                   key=lambda p: (-(p[0] + p[1]), -p[0]))
    steps = (a.shape[2] + 7) // 8
    s = torch.zeros((a.shape[0], a.shape[1], b.shape[1]))
    for k in range(steps):
        ks = slice(8 * k, 8 * k + 8)
        acc = s if steps <= chain_steps else torch.zeros_like(s)
        for i, j in pairs:
            acc = round_toward_zero(acc.double() + torch.bmm(
                pa[i][..., ks].double(), pb[j][..., ks].double().transpose(1, 2)))
        s = acc if steps <= chain_steps else s + acc
    return s


def exp2_of(s, mb):
    """2^(s log2(e) - mb), the exponent formed by one fused multiply-add."""
    return torch.exp2((s.double() * LOG2E - mb.double()).float())


def emulate_forward(theta, phi, g, split="3xtf32", chain_steps=CHAIN_STEPS):
    """The float32 forward kernel's arithmetic: (out, lse)."""
    th, ph, gf = theta.float(), phi.float(), g.float()
    b, n, _ = th.shape
    m_run = torch.full((b, n, 1), -torch.inf)
    l_run = torch.zeros((b, n, 1))
    acc = torch.zeros((b, n, gf.shape[2]))
    for j0 in range(0, ph.shape[1], CHUNK):
        s = logits(th, ph[:, j0:j0 + CHUNK], split, chain_steps)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        scale = torch.exp2((m_run - m_new) * LOG2E)
        p = exp2_of(s, (m_new * LOG2E).float())
        l_run = l_run * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + mm(p, gf[:, j0:j0 + CHUNK], split)
        m_run = m_new
    return acc / l_run, (m_run + torch.log(l_run))[..., 0]


def emulate_backward(theta, phi, g, ct, out, lse, split="3xtf32", chain_steps=CHAIN_STEPS):
    """The float32 backward kernel's arithmetic: (dtheta, dphi, dg), each
    output summed over chunks of 64 columns as its pass streams them."""
    th, ph, gf, ctf = theta.float(), phi.float(), g.float(), ct.float()
    rdot = (ctf * out.float()).sum(-1, keepdim=True)
    p = exp2_of(logits(th, ph, split, chain_steps), (lse[..., None] * LOG2E).float())
    ds = p * (mm(ctf, gf.transpose(1, 2), split) - rdot)
    if ph.shape[1] == 1:   # one key: the kernel sets dtheta and dphi to 0
        ds = torch.zeros_like(ds)
    dtheta = torch.zeros_like(th)
    for j0 in range(0, ph.shape[1], CHUNK):          # query pass: key chunks
        dtheta = dtheta + mm(ds[:, :, j0:j0 + CHUNK], ph[:, j0:j0 + CHUNK], split)
    dphi, dg = torch.zeros_like(ph), torch.zeros_like(gf)
    for i0 in range(0, th.shape[1], CHUNK):          # key pass: query chunks
        dst, pt = ds[:, i0:i0 + CHUNK].transpose(1, 2), p[:, i0:i0 + CHUNK].transpose(1, 2)
        dphi = dphi + mm(dst, th[:, i0:i0 + CHUNK], split)
        dg = dg + mm(pt, ctf[:, i0:i0 + CHUNK], split)
    return dtheta, dphi, dg


def _inputs(seed, b, n, m, dk, dv, logit_scale=1.0):
    """Normal queries and keys, values uniform in [-1, 1), a normal cotangent."""
    rng = np.random.default_rng(seed)
    return ((logit_scale * rng.standard_normal((b, n, dk))).astype(np.float32),
            (logit_scale * rng.standard_normal((b, m, dk))).astype(np.float32),
            rng.uniform(-1.0, 1.0, (b, m, dv)).astype(np.float32),
            rng.standard_normal((b, n, dv)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(x) for x in arrays)


def _np(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def errors(shape, seed=0, logit_scale=1.0, split="3xtf32", chain_steps=CHAIN_STEPS):
    """The emulated kernels under ``split`` against the plain float32 versions
    and JAX: forward max abs; lse max abs against the float32 logsumexp, its
    excess over rtol 1e-6 (the bound at large logits), and against float64
    (with the same rtol at large logits); the worst gradient relative to its
    largest entry."""
    theta, phi, g, ct = _inputs(seed, *shape, logit_scale=logit_scale)
    ops = _t(theta, phi, g)
    out, lse = emulate_forward(*ops, split=split, chain_steps=chain_steps)
    assert tuple(out.shape) == shape[:2] + shape[4:] and tuple(lse.shape) == shape[:2]
    want_lse = torch.logsumexp(torch.bmm(ops[0], ops[1].transpose(1, 2)), -1)
    lse_err = float((lse - want_lse).abs().max())
    lse_excess = float(((lse - want_lse).abs() - LSE_RTOL * want_lse.abs()).max())
    want64 = torch.logsumexp(torch.bmm(ops[0].double(), ops[1].double().transpose(1, 2)), -1)
    rtol64 = LSE_RTOL if logit_scale != 1.0 else 0.0
    lse64 = float(((lse.double() - want64).abs() - rtol64 * want64.abs()).max())
    jops = tuple(jnp.asarray(x) for x in (theta, phi, g))
    fwd = {"plain": float((out - sa_attention_plain(*ops)).abs().max()),
           "jax": float((out - _np(_jnp_attention(*jops))).abs().max())}
    res = {"forward": fwd, "lse": lse_err, "lse_excess": lse_excess, "lse64": lse64,
           "ref64": float((want_lse.double() - want64).abs().max())}
    if shape[2] > 1:   # at one key dtheta and dphi are 0: ONE_KEY's own test
        got = emulate_backward(*ops, torch.from_numpy(ct), out, lse, split=split,
                               chain_steps=chain_steps)
        plain = sa_attention_bwd_plain(*ops, torch.from_numpy(ct))
        _, vjp = jax.vjp(_jnp_attention, *jops)
        jgrads = vjp(jnp.asarray(ct))
        res["backward"] = {"plain": max(_rel(a, b) for a, b in zip(got, plain)),
                           "jax": max(_rel(a, _np(b)) for a, b in zip(got, jgrads))}
    return res


def _holds(res, margin=1.0):
    """Whether every gate holds ``margin`` times over."""
    ok = max(res["forward"].values()) * margin <= FWD_BOUND
    ok &= res["lse_excess"] * margin <= LSE_BOUND
    ok &= res["lse64"] * margin <= LSE_BOUND
    if "backward" in res:
        ok &= max(res["backward"].values()) * margin <= BWD_BOUND
    return ok


@pytest.mark.parametrize("b,n,m,dk,dv", SHAPES)
def test_forward_emulation_matches_plain_and_jax(b, n, m, dk, dv):
    """lse within 2e-5 of float64 everywhere, and of the float32 logsumexp at
    dk <= 24, where the card tests hold it so (logits up to about 20)."""
    res = errors((b, n, m, dk, dv))
    assert max(res["forward"].values()) * MARGIN <= FWD_BOUND, res
    assert res["lse64"] * MARGIN <= LSE_BOUND, res
    assert res["lse_excess"] * MARGIN <= LSE_BOUND, res
    if dk <= 24:
        assert res["lse"] * MARGIN <= LSE_BOUND, res


@pytest.mark.parametrize("b,n,m,dk,dv", [s for s in SHAPES if s[2] > 1])
def test_backward_emulation_matches_plain_and_jax(b, n, m, dk, dv):
    res = errors((b, n, m, dk, dv))
    assert max(res["backward"].values()) * MARGIN <= BWD_BOUND, res


def test_large_logits_hold_every_gate():
    """Logits near +-200: lse within 2e-5 + 1e-6 of itself, the forward within
    1e-4 and the gradients within 1e-4 of their largest entries, with margin."""
    res = errors(LARGE, seed=1, logit_scale=8.0)
    assert res["lse_excess"] * MARGIN <= LSE_BOUND, res
    assert res["lse64"] * MARGIN <= LSE_BOUND, res
    assert max(res["forward"].values()) * MARGIN <= FWD_BOUND, res
    assert max(res["backward"].values()) * MARGIN <= BWD_BOUND, res


def test_backward_at_one_key():
    """M=1: beta is 1, so dg is the sum of ct over the queries and dtheta,
    dphi are exactly 0, as in the plain version."""
    theta, phi, g, ct = _inputs(4, *ONE_KEY)
    ops = _t(theta, phi, g)
    out, lse = emulate_forward(*ops)
    dtheta, dphi, dg = emulate_backward(*ops, torch.from_numpy(ct), out, lse)
    plain = sa_attention_bwd_plain(*ops, torch.from_numpy(ct))
    assert _rel(dg, plain[2]) <= BWD_BOUND / MARGIN
    assert not bool(plain[0].any()) and not bool(plain[1].any())
    assert not bool(dtheta.any()) and not bool(dphi.any())


def test_logits_in_one_chain_break_lse_at_dk_192():
    """Summed in one chain over all 24 k8 steps, the logits lose up to a
    rounding toward zero a step: lse at dk=192 falls more than 2e-5 below
    float64, where the step sums hold it."""
    shape = next(s for s in SHAPES if s[3] == 192)
    res = errors(shape, chain_steps=10 ** 9)
    assert res["lse64"] > LSE_BOUND, res
    assert errors(shape)["lse64"] * MARGIN <= LSE_BOUND


def test_one_tf32_product_breaks_the_gates():
    """A single TF32 product keeps 10 mantissa bits: it breaks lse at ordinary
    logits, and every gate at logits near +-200."""
    res = errors(SHAPES[0], split="tf32")
    assert res["lse"] > LSE_BOUND, res
    big = errors(LARGE, seed=1, logit_scale=8.0, split="tf32")
    assert big["lse_excess"] > LSE_BOUND, big
    assert max(big["forward"].values()) > FWD_BOUND, big
    assert max(big["backward"].values()) > BWD_BOUND, big


def test_bf16_hi_lo_breaks_the_large_logit_gates():
    """bf16 hi + lo keeps about 16 bits: enough at ordinary logits for the
    forward, but lse at logits near +-200 is off by more than its bound."""
    big = errors(LARGE, seed=1, logit_scale=8.0, split="bf16x2")
    assert big["lse_excess"] > LSE_BOUND, big
    assert not _holds(big)


def test_tf32_rounding_is_rna():
    """Ties go away from zero; the result keeps 10 mantissa bits."""
    one = 1.0 + 2.0 ** -11                    # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0 ** 0.5], dtype=torch.float32)
    got = tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10 and got[1] == -(1.0 + 2.0 ** -10) and got[2] == 1.0
    mant = got[3].view(torch.int32) & 0x7FFFFF
    assert int(mant) & 0x1FFF == 0 and abs(float(got[3]) - math.sqrt(3)) <= 2.0 ** -11


if __name__ == "__main__":
    cases = [(s, 0, 1.0) for s in SHAPES] + [(LARGE, 1, 8.0)]
    for split in ("3xtf32", "bf16x3", "bf16x2", "tf32"):
        worst = {"forward": 0.0, "lse": 0.0, "lse_excess": -1.0, "lse64": -1.0, "backward": 0.0}
        for shape, seed, scale in cases:
            res = errors(shape, seed, scale, split)
            bwd = max(res["backward"].values()) if "backward" in res else 0.0
            tag = "x8 " if scale != 1.0 else ""
            print(f"{split} {tag}{shape}: forward vs plain {res['forward']['plain']:.3g}, vs JAX "
                  f"{res['forward']['jax']:.3g}; lse {res['lse']:.3g} (excess over rtol 1e-6 "
                  f"{res['lse_excess']:.3g}), vs float64 {res['lse64']:.3g}; backward "
                  f"{bwd:.3g}; all gates hold: {_holds(res)}")
            worst["forward"] = max(worst["forward"], max(res["forward"].values()))
            worst["lse"] = max(worst["lse"], res["lse"] if shape[3] <= 24 and scale == 1.0 else 0.0)
            worst["lse_excess"] = max(worst["lse_excess"], res["lse_excess"])
            worst["lse64"] = max(worst["lse64"], res["lse64"])
            worst["backward"] = max(worst["backward"], bwd)
        print(f"{split} worst: forward {worst['forward']:.3g} (bound {FWD_BOUND}), lse at dk <= 24 "
              f"{worst['lse']:.3g} (bound {LSE_BOUND}), lse excess at any logits "
              f"{worst['lse_excess']:.3g}, lse vs float64 {worst['lse64']:.3g}, backward "
              f"{worst['backward']:.3g} (bound {BWD_BOUND})")
    for shape, seed, scale in cases:
        ref = errors(shape, seed, scale)
        res = errors(shape, seed, scale, chain_steps=10 ** 9)
        print(f"3xtf32 {'x8 ' if scale != 1.0 else ''}{shape}: lse vs float64 with the logits in "
              f"one chain {res['lse64']:.3g}, with step sums above dk=32 {ref['lse64']:.3g}; the "
              f"float32 logsumexp vs float64 {ref['ref64']:.3g}")
