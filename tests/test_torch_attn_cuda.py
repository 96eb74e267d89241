"""The CUDA attention kernel against its plain PyTorch version, on the card.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attn_cuda.py -m gpu
"""
import pytest
import torch

from warpedganspace_torch.ops import attn_cuda
from warpedganspace_torch.ops.attn import sa_attention_plain

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


# f32: sums over M in another order, exp from the fast-math unit.
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
    leaves1 = [t.requires_grad_() for t in _problem(4, 2, 70, 30, 6, 10, cuda)]
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves1]
    torch.cos(attn_cuda.sa_attention(*leaves1)).sum().backward()
    torch.cos(sa_attention_plain(*leaves2)).sum().backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


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
