"""Where the bf16 tensor-core attention kernels round, emulated on the CPU.

The bf16 designs of ``warpedganspace_torch/csrc/sa_attention.cu`` and
``sa_attention_bwd.cu`` multiply bf16 operands on the tensor cores with
float32 accumulation, and round in their own places:

- the forward streams the keys in chunks of 64 with an online softmax; it
  rounds each chunk's unnormalised weights exp(s - m_running) to bf16 before
  the value product, rescales its float32 accumulator whenever the running
  maximum moves, and divides by the float32 sum of the weights at the end;
- the backward recomputes beta = exp(s - lse) from the forward's row
  statistic, takes rowsum(dbeta * beta) as rowsum(ct * out) of the forward's
  bf16 output, and rounds beta and ds to bf16 before their products.

The emulation below follows those rounding points in float32 arithmetic on
bf16-rounded values. It lives in this file only, on no path of the package.
It is held against the port's plain bf16 versions and against the JAX
package's ``_jnp_attention`` (and its VJP) in bf16, at the card tests' bound
of 3e-2: max abs for the forward (outputs of magnitude below 1), relative to
each gradient's largest entry for the backward. The inputs are made with numpy
from fixed seeds.

    PYTHONPATH=. python tests/test_torch_attn_tc_numerics.py   # prints the worst errors
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.ops.attn_pallas import _jnp_attention
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

torch.set_num_threads(1)

CHUNK = 64       # keys per chunk of the forward kernel
BOUND = 3e-2     # the card tests' bf16 bound

# (B, N, M, dk, dv): BigGAN-128's dk and dv, M below one chunk, at one key,
# one short of a chunk and past several, ragged dk and dv (the kernels' narrow
# copy path), dv wider than one of the forward's column tiles.
SHAPES = [
    (2, 100, 130, 24, 96),
    (1, 64, 1, 8, 57),
    (2, 70, 63, 20, 80),
    (1, 37, 1000, 24, 96),
    (2, 33, 200, 40, 200),
]
# At one key beta is 1 and dtheta, dphi are 0 up to the float32 sums' last
# bits, so no error relative to their largest entry means anything there:
# test_backward_at_one_key holds that shape.
BWD_SHAPES = [s for s in SHAPES if s[2] > 1]


def _inputs(seed, b, n, m, dk, dv, logit_scale=1.0):
    """Normal queries and keys, values uniform in [-1, 1), a normal cotangent."""
    rng = np.random.default_rng(seed)
    return ((logit_scale * rng.standard_normal((b, n, dk))).astype(np.float32),
            (logit_scale * rng.standard_normal((b, m, dk))).astype(np.float32),
            rng.uniform(-1.0, 1.0, (b, m, dv)).astype(np.float32),
            rng.standard_normal((b, n, dv)).astype(np.float32))


def _bf16(*arrays):
    return tuple(torch.from_numpy(x).bfloat16() for x in arrays)


def emulate_forward(theta, phi, g):
    """The bf16 forward kernel's arithmetic: (out in bf16, lse in float32)."""
    th, ph, gf = theta.float(), phi.float(), g.float()
    b, n, _ = th.shape
    m_run = torch.full((b, n, 1), -torch.inf)
    l_run = torch.zeros((b, n, 1))
    acc = torch.zeros((b, n, gf.shape[2]))
    for j0 in range(0, ph.shape[1], CHUNK):
        s = torch.bmm(th, ph[:, j0:j0 + CHUNK].transpose(1, 2))
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        scale = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        l_run = l_run * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + torch.bmm(p.bfloat16().float(), gf[:, j0:j0 + CHUNK])
        m_run = m_new
    return (acc / l_run).to(theta.dtype), (m_run + torch.log(l_run))[..., 0]


def emulate_backward(theta, phi, g, ct, out, lse):
    """The bf16 backward kernel's arithmetic: (dtheta, dphi, dg) in bf16."""
    th, ph, gf, ctf = theta.float(), phi.float(), g.float(), ct.float()
    rdot = (ctf * out.float()).sum(-1, keepdim=True)
    p = torch.exp(torch.bmm(th, ph.transpose(1, 2)) - lse[..., None])
    ds = p * (torch.bmm(ctf, gf.transpose(1, 2)) - rdot)
    ds16, p16 = ds.bfloat16().float(), p.bfloat16().float()
    return (torch.bmm(ds16, ph).to(theta.dtype), torch.bmm(ds16.transpose(1, 2), th).to(phi.dtype),
            torch.bmm(p16.transpose(1, 2), ctf).to(g.dtype))


def _jax_forward(theta, phi, g):
    return _jnp_attention(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (theta, phi, g)))


def _jax_backward(theta, phi, g, ct):
    _, vjp = jax.vjp(_jnp_attention, *(jnp.asarray(x).astype(jnp.bfloat16) for x in (theta, phi, g)))
    return vjp(jnp.asarray(ct).astype(jnp.bfloat16))


def _max_abs(got, ref):
    return float((got.float() - torch.from_numpy(np.array(ref, np.float32))).abs().max())


def _rel(got, ref):
    ref = torch.from_numpy(np.array(ref, np.float32))
    return float((got.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def forward_errors(shape, seed=0, logit_scale=1.0):
    """Max abs of the emulated forward against the plain bf16 version and JAX."""
    theta, phi, g, _ = _inputs(seed, *shape, logit_scale=logit_scale)
    out, _ = emulate_forward(*_bf16(theta, phi, g))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape[:2] + shape[4:]
    plain = sa_attention_plain(*_bf16(theta, phi, g))
    jax_out = np.asarray(_jax_forward(theta, phi, g).astype(jnp.float32))
    return _max_abs(out, plain.float()), _max_abs(out, jax_out)


def backward_errors(shape, seed=0, logit_scale=1.0):
    """Each gradient of the emulated backward against the plain bf16 backward
    and the JAX VJP, relative to the reference's largest entry: the worst of
    the three against each."""
    theta, phi, g, ct = _inputs(seed, *shape, logit_scale=logit_scale)
    ops = _bf16(theta, phi, g)
    ct16 = _bf16(ct)[0]
    out, lse = emulate_forward(*ops)
    got = emulate_backward(*ops, ct16, out, lse)
    plain = sa_attention_bwd_plain(*ops, ct16)
    jax_grads = _jax_backward(theta, phi, g, ct)
    for a, like in zip(got, ops):
        assert a.dtype == torch.bfloat16 and a.shape == like.shape
    return (max(_rel(a, b.float()) for a, b in zip(got, plain)),
            max(_rel(a, np.asarray(b.astype(jnp.float32))) for a, b in zip(got, jax_grads)))


@pytest.mark.parametrize("b,n,m,dk,dv", SHAPES)
def test_forward_emulation_matches_plain_bf16(b, n, m, dk, dv):
    err, _ = forward_errors((b, n, m, dk, dv))
    assert err <= BOUND, err


@pytest.mark.parametrize("b,n,m,dk,dv", SHAPES)
def test_forward_emulation_matches_jax_bf16(b, n, m, dk, dv):
    _, err = forward_errors((b, n, m, dk, dv))
    assert err <= BOUND, err


@pytest.mark.parametrize("b,n,m,dk,dv", BWD_SHAPES)
def test_backward_emulation_matches_plain_bf16(b, n, m, dk, dv):
    err, _ = backward_errors((b, n, m, dk, dv))
    assert err <= BOUND, err


@pytest.mark.parametrize("b,n,m,dk,dv", BWD_SHAPES)
def test_backward_emulation_matches_jax_bf16(b, n, m, dk, dv):
    _, err = backward_errors((b, n, m, dk, dv))
    assert err <= BOUND, err


def test_backward_at_one_key():
    """M=1: dg against the plain bf16 backward within the bound; dtheta and
    dphi are the rounding of rowsum(ct * out) against ct . g, far below it."""
    theta, phi, g, ct = _inputs(4, 1, 64, 1, 8, 57)
    ops = _bf16(theta, phi, g)
    ct16 = _bf16(ct)[0]
    out, lse = emulate_forward(*ops)
    dtheta, dphi, dg = emulate_backward(*ops, ct16, out, lse)
    assert _rel(dg, sa_attention_bwd_plain(*ops, ct16)[2].float()) <= BOUND
    assert float(dtheta.float().abs().max()) <= 1e-4
    assert float(dphi.float().abs().max()) <= 1e-4


def test_large_logits_in_bf16():
    """Logits near +-200: the running maximum keeps every exp() in range, and
    the backward's lse does the same for beta."""
    shape = (2, 100, 130, 16, 32)
    assert max(forward_errors(shape, seed=1, logit_scale=8.0)) <= BOUND
    assert max(backward_errors(shape, seed=1, logit_scale=8.0)) <= BOUND


def test_emulated_lse_is_the_float32_logsumexp():
    """The forward's row statistic is that of the float32 weights, not of
    their bf16 roundings: within the card tests' 2e-5."""
    theta, phi, g, _ = _inputs(2, 2, 100, 1000, 24, 96)
    ops = _bf16(theta, phi, g)
    _, lse = emulate_forward(*ops)
    want = torch.logsumexp(torch.bmm(ops[0].float(), ops[1].float().transpose(1, 2)), -1)
    assert float((lse - want).abs().max()) <= 2e-5


def test_chunked_rounding_differs_from_the_plain_rounding():
    """The emulation is not the plain version under another name: rounding the
    unnormalised weights per chunk gives other bits than rounding the
    normalised ones, at the level of one bf16 ulp."""
    theta, phi, g, _ = _inputs(3, 2, 100, 130, 24, 96)
    ops = _bf16(theta, phi, g)
    out, _ = emulate_forward(*ops)
    plain = sa_attention_plain(*ops)
    assert not torch.equal(out, plain)
    assert float((out.float() - plain.float()).abs().max()) <= BOUND


if __name__ == "__main__":
    rows = [(s, forward_errors(s), backward_errors(s) if s in BWD_SHAPES else (0.0, 0.0))
            for s in SHAPES]
    for shape, (fp, fj), (bp, bj) in rows:
        print(f"{shape}: forward max abs vs plain {fp:.3g}, vs JAX {fj:.3g}; backward "
              f"(of each gradient's largest entry) vs plain {bp:.3g}, vs JAX {bj:.3g}")
    big = (2, 100, 130, 16, 32)
    print(f"large logits {big}: forward {forward_errors(big, 1, 8.0)}, backward "
          f"{backward_errors(big, 1, 8.0)}")
    print(f"worst: forward {max(max(r[1]) for r in rows):.3g}, "
          f"backward {max(max(r[2]) for r in rows):.3g}")
