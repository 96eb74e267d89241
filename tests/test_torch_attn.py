"""The port's SA attention against the JAX package's, on the CPU.

The same numpy inputs go through ``sa_attention_fusable`` (the Pallas kernel in
interpret mode where its shapes fit, the jnp path otherwise) and through the
port's plain version; on CPU tensors the port's ``sa_attention`` wrapper runs
that plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.ops.attn_pallas import _jnp_attention, _kernel_fits, sa_attention_fusable
from warpedganspace_torch.ops import attn_cuda
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

torch.set_num_threads(1)

# (B, N, M, dk, dv, does the JAX wrapper take its Pallas kernel)
SHAPES = [
    (2, 1024, 256, 8, 32, True),     # the kernel path, interpret mode
    (2, 256, 128, 24, 96, True),     # BigGAN-128's dk and dv
    (3, 100, 25, 6, 10, False),      # ragged: the jnp path
]


def _inputs(seed, b, n, m, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, dk)).astype(np.float32),
            rng.standard_normal((b, m, dk)).astype(np.float32),
            rng.standard_normal((b, m, dv)).astype(np.float32))


@pytest.mark.parametrize("b,n,m,dk,dv,fits", SHAPES)
def test_plain_matches_jax_f32(b, n, m, dk, dv, fits):
    theta, phi, g = _inputs(0, b, n, m, dk, dv)
    assert _kernel_fits(jnp.asarray(theta), jnp.asarray(g)) == fits
    ref = np.asarray(sa_attention_fusable(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(g)))
    got = sa_attention_plain(torch.from_numpy(theta), torch.from_numpy(phi),
                             torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n, dv)
    # f32 on both sides; sums over M and dk in another order.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,n,m,dk,dv,fits", SHAPES)
def test_plain_matches_jax_bf16(b, n, m, dk, dv, fits):
    theta, phi, g = _inputs(1, b, n, m, dk, dv)
    jt, jp, jg = (jnp.asarray(x).astype(jnp.bfloat16) for x in (theta, phi, g))
    ref = np.asarray(sa_attention_fusable(jt, jp, jg).astype(jnp.float32))
    got = sa_attention_plain(*(torch.from_numpy(x).bfloat16() for x in (theta, phi, g)))
    assert got.dtype == torch.bfloat16
    # One bf16 ulp of the O(1) outputs (2^-7 relative), where a last-bit
    # difference of the f32 sums lands on another side of a rounding boundary.
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2)


def test_wrapper_on_cpu_is_the_plain_version():
    theta, phi, g = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 16, 8, 12))
    before = attn_cuda.launches
    got = attn_cuda.sa_attention(theta, phi, g)
    assert attn_cuda.launches == before          # no kernel for CPU tensors
    assert torch.equal(got, sa_attention_plain(theta, phi, g))


def test_no_scale_on_the_logits():
    """SA-GAN's attention has no 1/sqrt(dk): two keys, logits 0 and log(3)."""
    theta = torch.tensor([[[1.0, 0.0]]])
    phi = torch.tensor([[[0.0, 0.0], [float(np.log(3.0)), 0.0]]])
    g = torch.tensor([[[0.0], [1.0]]])
    assert sa_attention_plain(theta, phi, g).item() == pytest.approx(0.75, abs=1e-6)


def test_gradients_match_jax(monkeypatch):
    """On CPU tensors autograd differentiates the plain version; hold it to
    ``jax.grad`` of the JAX package's jnp attention. Then the
    autograd.Function's own backward (the CUDA path's), which hands the saved
    tensors to the backward kernel and masks what needs no gradient."""
    theta, phi, g = _inputs(3, 2, 48, 12, 8, 16)
    ct = np.random.default_rng(4).standard_normal((2, 48, 16)).astype(np.float32)

    def loss(t, p, gg):
        return jnp.sum(_jnp_attention(t, p, gg) * ct)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (theta, phi, g)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (theta, phi, g)]
    (attn_cuda.sa_attention(*leaves) * torch.from_numpy(ct)).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=0, atol=1e-4)

    # The Function itself, with both launches replaced by the plain versions
    # since there is no card here: the forward keeps (theta, phi, g, out, lse)
    # and the backward passes them on with a contiguous cotangent.
    class _OnCPU(attn_cuda._SAAttention):
        @staticmethod
        def forward(ctx, t, p, gg):
            out = sa_attention_plain(t, p, gg)
            lse = torch.logsumexp(torch.bmm(t, p.transpose(1, 2)), dim=-1)
            ctx.save_for_backward(t, p, gg, out, lse)
            return out

    def plain_launch_bwd(t, p, gg, out, lse, cot):
        assert cot.is_contiguous() and tuple(lse.shape) == tuple(out.shape[:2])
        return sa_attention_bwd_plain(t, p, gg, cot)

    monkeypatch.setattr(attn_cuda, "_launch_bwd", plain_launch_bwd)
    leaves2 = [torch.from_numpy(x).requires_grad_(i != 1) for i, x in enumerate((theta, phi, g))]
    (_OnCPU.apply(*leaves2) * torch.from_numpy(ct)).sum().backward()
    assert leaves2[1].grad is None
    for i in (0, 2):
        np.testing.assert_allclose(leaves2[i].grad.numpy(), np.asarray(ref[i]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_launch_rejects_bad_operands(bad):
    """The operand checks run before any build or launch, so they are testable here."""
    theta, phi, g = (torch.from_numpy(x) for x in _inputs(5, 2, 16, 8, 4, 6))
    if bad == "dtype":
        with pytest.raises(TypeError, match="share one dtype"):
            attn_cuda._launch(theta, phi.bfloat16(), g)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            attn_cuda._launch(theta.double(), phi.double(), g.double())
    elif bad == "shape":
        with pytest.raises(ValueError, match="do not match"):
            attn_cuda._launch(theta, phi[:, :5], g)
        with pytest.raises(ValueError, match="contiguous"):
            attn_cuda._launch(theta.transpose(0, 1).contiguous().transpose(0, 1), phi, g)
    else:
        with pytest.raises(ValueError, match=r"\(B, N, dk\)"):
            attn_cuda._launch(theta[0], phi, g)
