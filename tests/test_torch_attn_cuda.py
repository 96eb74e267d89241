"""The CUDA attention kernels (forward and backward) against their plain PyTorch
versions, on the card.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attn_cuda.py -m gpu
"""
import pytest
import torch

from warpedganspace_torch.ops import attn_cuda, attn_cuda_cores
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # f32 comparisons: keep the plain version's matmuls out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(seed, b, n, m, dk, dv, device, dtype=torch.float32):
    """Normal queries and keys (a peaked softmax), values uniform in [-1, 1):
    every output is a convex combination of values of magnitude below 1."""
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((b, n, dk), generator=gen)
    phi = torch.randn((b, m, dk), generator=gen)
    g = torch.rand((b, m, dv), generator=gen) * 2 - 1
    return tuple(t.to(device=device, dtype=dtype) for t in (theta, phi, g))


def _check(theta, phi, g, tol):
    before = attn_cuda.launches
    got = attn_cuda.sa_attention(theta, phi, g)
    torch.cuda.synchronize()
    assert attn_cuda.launches == before + 1
    ref = sa_attention_plain(theta, phi, g)
    assert got.dtype == theta.dtype and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, err


# f32: sums over M in another order, exp from the fast-math unit, products in
# split precision (tests/test_torch_attn_f32_split_numerics.py).
# bf16: one ulp of outputs below 1 is 2^-8; 3e-2 is the smoke test's bound.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,dk,dv", [
    (16, 4096, 1024, 24, 96),    # BigGAN-128, attention at 64x64, the timed shape
    (64, 4096, 1024, 24, 96),    # one render batch of the BigGAN traversal
    (1, 4096, 1024, 24, 96),     # one sampled code
    (2, 1000, 250, 20, 80),      # ragged everywhere
])
def test_smoke_shapes(cuda, dtype, b, n, m, dk, dv):
    _check(*_problem(0, b, n, m, dk, dv, cuda, dtype), TOL[dtype])


@pytest.mark.parametrize("b,n,m,dk,dv", [
    (1, 1, 1, 1, 1),             # one key: the softmax is 1
    (3, 5, 7, 3, 2),             # nothing a multiple of anything
    (2, 129, 65, 5, 33),         # one row and one key past a tile, CPT = 2
    (2, 64, 16, 192, 768),       # attention at 8x8 of a ch=96 model: dk at its limit, 6 column tiles
    (1, 256, 64, 48, 192),       # dv split into two tiles of 96
    (2, 300, 130, 12, 128),      # CPT = 4, three key chunks
    (1, 1024, 256, 2, 8),        # ch=16 test models
])
def test_ragged_sweep(cuda, b, n, m, dk, dv):
    _check(*_problem(1, b, n, m, dk, dv, cuda), TOL[torch.float32])


def test_large_logits_do_not_overflow(cuda):
    """Logits near +-200: exp() of them overflows f32 without the running maximum."""
    theta, phi, g = _problem(2, 2, 200, 100, 16, 32, cuda)
    _check(theta * 8, phi * 8, g, TOL[torch.float32])


def test_limits_raise(cuda):
    theta, phi, g = _problem(3, 1, 8, 8, 200, 4, cuda)
    with pytest.raises(ValueError, match="dk <= 192"):
        attn_cuda.sa_attention(theta, phi, g)
    theta, phi, g = _problem(3, 1, 8, 8, 4, 4, cuda)
    with pytest.raises(TypeError, match="share one dtype"):
        attn_cuda.sa_attention(theta, phi.bfloat16(), g)
    with pytest.raises(ValueError, match="contiguous"):
        attn_cuda.sa_attention(theta, phi, g.transpose(1, 2).contiguous().transpose(1, 2))
    empty = attn_cuda.sa_attention(theta[:0], phi[:0], g[:0])
    assert tuple(empty.shape) == (0, 8, 4)


def test_backward_is_plain_vjp(cuda):
    """Autograd through the wrapper launches the backward kernel, and the
    gradients are those of the plain version."""
    leaves1 = [t.requires_grad_() for t in _problem(4, 2, 70, 30, 6, 10, cuda)]
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves1]
    before = attn_cuda.launches, attn_cuda.bwd_launches
    torch.cos(attn_cuda.sa_attention(*leaves1)).sum().backward()
    torch.cuda.synchronize()
    assert (attn_cuda.launches, attn_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    torch.cos(sa_attention_plain(*leaves2)).sum().backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,dk,dv", [
    (32, 4096, 1024, 24, 96),    # BigGAN-128 training, batch 32
    (2, 1000, 250, 20, 80),      # ragged everywhere
    (2, 301, 130, 12, 200),      # ragged N, dv past one column tile: only the first writes lse
    (1, 1, 1, 1, 1),             # one key: lse is the logit
])
def test_saved_out_and_lse(cuda, dtype, b, n, m, dk, dv):
    """What the backward keeps: the forward kernel's output with the row
    statistics asked for, and every row's log-sum-exp in float32."""
    theta, phi, g = _problem(7, b, n, m, dk, dv, cuda, dtype)
    before = attn_cuda.launches
    out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    torch.cuda.synchronize()
    assert attn_cuda.launches == before + 1
    ref = sa_attention_plain(theta, phi, g)
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]
    # The same output as without the statistics, to the bit.
    assert torch.equal(out, attn_cuda.sa_attention(theta, phi, g))
    want = torch.logsumexp(torch.bmm(theta.float(), phi.float().transpose(1, 2)), -1)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    # Values up to about 20: some float32 ulps of 2e-6.
    assert float((lse - want).abs().max()) <= 2e-5


def test_saved_lse_of_large_logits(cuda):
    """Logits near +-200: lse is the running maximum plus a log, never an exp of them."""
    theta, phi, g = _problem(2, 2, 200, 100, 16, 32, cuda)
    _, lse = attn_cuda.sa_attention_saved(theta * 8, phi * 8, g)
    want = torch.logsumexp(torch.bmm(theta * 8, (phi * 8).transpose(1, 2)), -1)
    assert bool(torch.isfinite(lse).all())
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=2e-5)


def _check_bwd(theta, phi, g, tol, seed=9):
    """The backward kernel against the plain backward: each gradient within
    ``tol`` of its largest entry."""
    gen = torch.Generator().manual_seed(seed)
    ct = torch.randn(theta.shape[:2] + g.shape[2:], generator=gen).to(theta)
    before = attn_cuda.bwd_launches
    got = attn_cuda.sa_attention_bwd(theta, phi, g, ct)
    torch.cuda.synchronize()
    assert attn_cuda.bwd_launches == before + 1
    ref = sa_attention_bwd_plain(theta, phi, g, ct)
    for name, a, b, like in zip(("dtheta", "dphi", "dg"), got, ref, (theta, phi, g)):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)
        assert err <= tol, (name, err)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,dk,dv", [
    (32, 4096, 1024, 24, 96),    # BigGAN-128 training, batch 32
    (1, 4096, 1024, 24, 96),     # one sample
    (2, 1000, 250, 20, 80),      # ragged everywhere
])
def test_backward_smoke_shapes(cuda, dtype, b, n, m, dk, dv):
    _check_bwd(*_problem(0, b, n, m, dk, dv, cuda, dtype), TOL[dtype])


@pytest.mark.parametrize("b,n,m,dk,dv", [
    (1, 1, 1, 1, 1),             # one key: beta is 1 and dtheta, dphi are 0
    (3, 5, 7, 3, 2),             # nothing a multiple of anything
    (2, 129, 65, 5, 33),         # one row and one column past a tile
    (1, 1024, 256, 48, 192),     # attention at 32x32 of a ch=96 model: two dg tiles of 96
    (2, 300, 130, 12, 128),      # CPT2 = 4
    (2, 130, 300, 40, 100),      # CPT1 = 2, CPT2 = 4, more keys than queries
    (1, 64, 200, 192, 40),       # dk at its limit: three dphi / dtheta column tiles
    (1, 1024, 256, 2, 8),        # ch=16 test models
])
def test_backward_ragged_sweep(cuda, b, n, m, dk, dv):
    _check_bwd(*_problem(1, b, n, m, dk, dv, cuda), TOL[torch.float32])


def test_backward_large_logits(cuda):
    """Logits near +-200: the saved log-sum-exp keeps exp() in range."""
    theta, phi, g = _problem(2, 2, 200, 100, 16, 32, cuda)
    _check_bwd(theta * 8, phi * 8, g, TOL[torch.float32])


def test_backward_is_deterministic(cuda):
    """No atomics: two runs give the same bits."""
    ops = _problem(5, 4, 1024, 256, 24, 96, cuda)
    a = _check_bwd(*ops, TOL[torch.float32])
    b = _check_bwd(*ops, TOL[torch.float32])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_backward_limits_raise(cuda):
    theta, phi, g = _problem(3, 1, 8, 8, 96, 384, cuda)
    ct = torch.zeros((1, 8, 384), device=cuda)
    with pytest.raises(ValueError, match="dv <= "):
        attn_cuda.sa_attention_bwd(theta, phi, g, ct)
    theta, phi, g = _problem(3, 1, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError, match="ct must be"):
        attn_cuda.sa_attention_bwd(theta, phi, g, torch.zeros((1, 8, 5), device=cuda))
    # A non-contiguous cotangent (the generator's transpose) is taken by autograd.
    leaves = [t.requires_grad_() for t in (theta, phi, g)]
    out = attn_cuda.sa_attention(*leaves)
    out.transpose(1, 2).contiguous().transpose(1, 2).sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


def test_no_grad_forward_saves_nothing(cuda):
    theta, phi, g = _problem(6, 1, 64, 16, 8, 8, cuda)
    with torch.no_grad():
        out = attn_cuda.sa_attention(theta.requires_grad_(), phi, g)
    assert not out.requires_grad


def test_biggan_block_reaches_the_kernel(cuda):
    """The generator's attention block calls the kernel on the card, and agrees
    with the same block on the CPU (where the wrapper runs the plain version)."""
    from warpedganspace_torch.models.biggan import Attention

    block = Attention(64, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for conv in (block.theta, block.phi, block.g, block.o):
            conv.weight.mul_(10.0)               # logits of O(1), not of the 0.02 init
        block.gamma.fill_(1.0)
        x = torch.randn((2, 64, 16, 16), generator=torch.Generator().manual_seed(6))
        ref = block(x)
        before = attn_cuda.launches
        got = block.to(cuda)(x.to(cuda))
        torch.cuda.synchronize()
    assert attn_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


# Both dtypes run on the tensor cores: bf16 as it is, f32 in split precision.
BF16 = torch.bfloat16
DKS = [8, 16, 20, 24, 40, 48, 192]      # one and two k16 steps, ragged, 12 steps
DVS = [57, 80, 96, 192, 200]            # ragged, one column tile, two tiles


def test_designs(cuda):
    assert attn_cuda.design(BF16) == "tensor cores, mma.sync bf16"
    assert attn_cuda.design(torch.float32) == "tensor cores, mma.sync 3xTF32"
    assert attn_cuda.bwd_design(BF16) == "tensor cores, mma.sync bf16"
    assert attn_cuda.bwd_design(torch.float32) == "tensor cores, mma.sync 3xTF32"


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("dv", DVS)
@pytest.mark.parametrize("dk", DKS)
def test_dk_dv_sweep(cuda, dk, dv, dtype):
    """N=200 (not a multiple of a query tile), M=150 (a partial chunk);
    f32 keeps theta in registers up to dk=32 and reads it again above."""
    _check(*_problem(10, 2, 200, 150, dk, dv, cuda, dtype), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("dv", DVS)
@pytest.mark.parametrize("dk", DKS)
def test_backward_dk_dv_sweep(cuda, dk, dv, dtype):
    """Within the limit against the plain backward; above it the wrapper raises."""
    ops = _problem(10, 2, 200, 150, dk, dv, cuda, dtype)
    if dv > attn_cuda.build_bwd().sa_attention_bwd_max_dv(dk):
        with pytest.raises(ValueError, match="dv <= "):
            attn_cuda.sa_attention_bwd(*ops, torch.zeros((2, 200, dv), device=cuda, dtype=dtype))
        return
    _check_bwd(*ops, TOL[dtype])


@pytest.mark.parametrize("dk", [48, 192])
def test_f32_saved_lse_above_dk_32(cuda, dk):
    """Above dk=32 the f32 forward sums each k8 step of its logits apart: lse
    within 2e-5 of float64 (logits up to about 60 at dk=192, where the float32
    logsumexp itself lies up to about 3e-5 from float64)."""
    theta, phi, g = _problem(16, 2, 200, 150, dk, 96, cuda)
    out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    torch.cuda.synchronize()
    assert float((out - sa_attention_plain(theta, phi, g)).abs().max()) <= TOL[torch.float32]
    want = torch.logsumexp(torch.bmm(theta.double(), phi.double().transpose(1, 2)), -1)
    assert float((lse.double() - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("b,dk,dv", [
    (16, 24, 96),                # BigGAN-128, the timed shape
    (64, 12, 48),                # BigGAN-128 D's operands (D_ch=96)
    (1, 24, 96),                 # one sampled code
])
def test_f32_design_agrees_with_the_cuda_core_design(cuda, b, dk, dv):
    """The shipped f32 design and the CUDA-core design it replaced, at the
    timed shapes: outputs within the f32 bound, lse within 2e-5."""
    theta, phi, g = _problem(14, b, 4096, 1024, dk, dv, cuda)
    out, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    out_cc, lse_cc = attn_cuda_cores.cc_forward(theta, phi, g, want_lse=True)
    torch.cuda.synchronize()
    assert float((out - out_cc).abs().max()) <= TOL[torch.float32]
    assert float((lse - lse_cc).abs().max()) <= 2e-5


def test_f32_backward_agrees_with_the_cuda_core_design(cuda):
    """The same at the training shape, B=32: each gradient within the f32
    bound of its largest entry."""
    theta, phi, g = _problem(15, 32, 4096, 1024, 24, 96, cuda)
    ct = torch.randn((32, 4096, 96), generator=torch.Generator().manual_seed(16)).to(cuda)
    saved = attn_cuda.sa_attention_saved(theta, phi, g)
    got = attn_cuda.sa_attention_bwd(theta, phi, g, ct, saved=saved)
    ref = attn_cuda_cores.cc_backward(theta, phi, g, *saved, ct)
    torch.cuda.synchronize()
    for name, a, b in zip(("dtheta", "dphi", "dg"), got, ref):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= TOL[torch.float32], (name, err)


@pytest.mark.parametrize("m", [1, 63, 1000])
def test_bf16_ragged_keys(cuda, m):
    """M at one key, one short of a 64-key chunk and past several; N=100."""
    ops = _problem(11, 2, 100, m, 24, 96, cuda, BF16)
    _check(*ops, TOL[BF16])
    if m > 1:
        _check_bwd(*ops, TOL[BF16])
        return
    # One key: beta is 1 and dtheta, dphi are 0 up to the f32 sums' last bits
    # (rowsum(ct * out) against ct . g), so they are held in absolute terms.
    ct = torch.randn((2, 100, 96), generator=torch.Generator().manual_seed(9)).to(ops[0])
    got = attn_cuda.sa_attention_bwd(*ops, ct)
    ref = sa_attention_bwd_plain(*ops, ct)
    assert float(got[0].float().abs().max()) <= 1e-4
    assert float(got[1].float().abs().max()) <= 1e-4
    err = float((got[2].float() - ref[2].float()).abs().max()) / float(ref[2].float().abs().max())
    assert err <= TOL[BF16], err


@pytest.mark.parametrize("b,n,m,dk,dv", [
    (1, 1, 1, 1, 1),
    (3, 5, 7, 3, 2),
    (2, 129, 65, 5, 33),
    (1, 1024, 256, 48, 192),
    (2, 300, 130, 12, 128),
    (2, 130, 300, 40, 100),
    (1, 64, 200, 192, 40),
    (1, 1024, 256, 2, 8),
])
def test_bf16_backward_ragged_sweep(cuda, b, n, m, dk, dv):
    """The f32 ragged sweep's shapes through the bf16 design."""
    _check_bwd(*_problem(1, b, n, m, dk, dv, cuda, BF16), TOL[BF16])


def _misaligned(t):
    """The same values at a base address 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_bf16_unaligned_copy_path(cuda):
    """dk=24, dv=96 rows, but no operand 16-byte aligned: every chunk is staged
    by element loads, forward and backward."""
    theta, phi, g = (_misaligned(t) for t in _problem(12, 2, 300, 200, 24, 96, cuda, BF16))
    assert theta.data_ptr() % 16 != 0 and theta.is_contiguous()
    _check(theta, phi, g, TOL[BF16])
    _check_bwd(theta, phi, g, TOL[BF16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_max_dv_edge(cuda, dtype):
    """dv at the backward's limit beside dk=24 runs and matches; one step past
    it raises, naming the limit."""
    lim = attn_cuda.build_bwd().sa_attention_bwd_max_dv(24)
    assert lim >= 220
    _check_bwd(*_problem(13, 1, 130, 70, 24, lim, cuda, dtype), TOL[dtype])
    ops = _problem(13, 1, 8, 8, 24, lim + 4, cuda, dtype)
    with pytest.raises(ValueError, match=f"dv <= {lim}"):
        attn_cuda.sa_attention_bwd(*ops, torch.zeros((1, 8, lim + 4), device=cuda, dtype=dtype))


def test_bf16_backward_is_deterministic(cuda):
    """No atomics in the tensor-core design either: two runs give the same bits."""
    ops = _problem(5, 4, 1024, 256, 24, 96, cuda, BF16)
    a = _check_bwd(*ops, TOL[BF16])
    b = _check_bwd(*ops, TOL[BF16])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bf16_large_logits(cuda):
    """Logits near +-200 in bf16: the running maximum keeps the forward's
    exponentials in range, the saved log-sum-exp the backward's."""
    theta, phi, g = _problem(2, 2, 200, 100, 16, 32, cuda, BF16)
    theta, phi = theta * 8, phi * 8
    _check(theta, phi, g, TOL[BF16])
    _, lse = attn_cuda.sa_attention_saved(theta, phi, g)
    want = torch.logsumexp(torch.bmm(theta.float(), phi.float().transpose(1, 2)), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=2e-5)
    _check_bwd(theta, phi, g, TOL[BF16])


def _signed_mean(pairs):
    """The mean error along the float64 reference's sign over its mean
    magnitude, pooled over (got, ref64) pairs: negative is a result shrunk
    toward zero."""
    signed = sum(float(((a.double() - r) * r.sign()).sum()) for a, r in pairs)
    return signed / sum(float(r.abs().sum()) for _, r in pairs)


def test_bf16_backward_signed_mean(cuda):
    """The tensor cores' f32 accumulation rounds toward zero. In one chain of
    mma.sync over the N=4096 queries of BigGAN-128's training shape the bf16
    key pass shrank dphi and dg 2.1x as far from float64 as the plain bf16
    version lies (the sign-weighted mean error, 16 draws); its accumulators
    now go into f32 sums every 4 chunks. Over the same 16 draws
    (scripts/measure_attention_bf16_error.py's), each gradient's signed mean
    error is at most twice the plain bf16 version's, and of its sign."""
    b, n, m, dk, dv = 32, 4096, 1024, 24, 96
    got = {name: [] for name in ("dtheta", "dphi", "dg")}
    plain = {name: [] for name in got}
    with torch.no_grad():
        for seed in range(100, 116):
            gen = torch.Generator().manual_seed(seed)
            theta = torch.randn((b, n, dk), generator=gen)
            phi = torch.randn((b, m, dk), generator=gen)
            g = torch.rand((b, m, dv), generator=gen) * 2 - 1
            ct = torch.randn((b, n, dv), generator=gen)
            theta, phi, g, ct = (t.to(cuda, BF16) for t in (theta, phi, g, ct))
            th, ph, gd, cd = (t.double() for t in (theta, phi, g, ct))
            beta = (th @ ph.transpose(1, 2)).softmax(-1)
            dbeta = cd @ gd.transpose(1, 2)
            ds = beta * (dbeta - (dbeta * beta).sum(-1, keepdim=True))
            del dbeta
            ref = (ds @ ph, ds.transpose(1, 2) @ th, beta.transpose(1, 2) @ cd)
            del ds, beta
            kern = attn_cuda.sa_attention_bwd(theta, phi, g, ct)
            base = sa_attention_bwd_plain(theta, phi, g, ct)
            for i, name in enumerate(got):
                got[name].append((kern[i], ref[i]))
                plain[name].append((base[i], ref[i]))
    for name in got:
        k, p = _signed_mean(got[name]), _signed_mean(plain[name])
        assert p < 0 and 2 * p <= k <= 0, (name, k, p)
