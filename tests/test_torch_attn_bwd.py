"""The port's plain attention backward against the JAX package's, on the CPU.

The same numpy inputs go through ``_pallas_attention_bwd`` (the fused backward
kernel, in interpret mode, as ``tests/test_biggan.py`` runs it on the CPU),
through ``jax.grad`` of ``_jnp_attention`` at a shape the Pallas kernel does
not take, through ``torch.autograd.grad`` of the port's plain forward, and
through the port's ``sa_attention_bwd_plain``. On CPU tensors the port's
wrappers run the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.ops.attn_pallas import (_jnp_attention, _kernel_fits,
                                                _pallas_attention_bwd)
from warpedganspace_torch.ops import attn_cuda
from warpedganspace_torch.ops.attn import sa_attention_bwd_plain, sa_attention_plain

torch.set_num_threads(1)

KERNEL_SHAPE = (3, 256, 128, 8, 16)      # the Pallas kernel's own small test shape
RAGGED_SHAPE = (2, 100, 25, 6, 10)       # ragged for the TPU kernel: the jnp path


def _inputs(seed, b, n, m, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, dk)).astype(np.float32),
            rng.standard_normal((b, m, dk)).astype(np.float32),
            rng.standard_normal((b, m, dv)).astype(np.float32),
            rng.standard_normal((b, n, dv)).astype(np.float32))


def _plain(arrays, dtype=torch.float32):
    return sa_attention_bwd_plain(*(torch.from_numpy(x).to(dtype) for x in arrays))


def test_plain_matches_pallas_backward_kernel():
    arrays = _inputs(0, *KERNEL_SHAPE)
    assert _kernel_fits(jnp.asarray(arrays[0]), jnp.asarray(arrays[2]))
    ref = _pallas_attention_bwd(*(jnp.asarray(x) for x in arrays))
    got = _plain(arrays)
    for name, a, b, like in zip(("dtheta", "dphi", "dg"), got, ref, arrays):
        assert a.dtype == torch.float32 and tuple(a.shape) == like.shape, name
        # The fused backward accumulates dphi and dg across query blocks in
        # another order: the bound of tests/test_biggan.py.
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3, err_msg=name)


def test_plain_matches_pallas_backward_kernel_bf16():
    arrays = _inputs(1, *KERNEL_SHAPE)
    ref = _pallas_attention_bwd(*(jnp.asarray(x).astype(jnp.bfloat16) for x in arrays))
    got = _plain(arrays, torch.bfloat16)
    for name, a, b in zip(("dtheta", "dphi", "dg"), got, ref):
        assert a.dtype == torch.bfloat16, name
        want = np.asarray(b.astype(jnp.float32))
        # bf16 operands, ds and beta rounded to bf16 on both sides, and a
        # bf16 result: one ulp of the largest entry.
        np.testing.assert_allclose(a.float().numpy(), want, rtol=0,
                                   atol=3e-2 * float(np.abs(want).max()), err_msg=name)


def test_plain_matches_jax_grad_at_a_ragged_shape():
    arrays = _inputs(2, *RAGGED_SHAPE)
    theta, phi, g, ct = (jnp.asarray(x) for x in arrays)
    assert not _kernel_fits(theta, g)
    _, vjp = jax.vjp(_jnp_attention, theta, phi, g)
    ref = vjp(ct)
    for name, a, b in zip(("dtheta", "dphi", "dg"), _plain(arrays), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", [KERNEL_SHAPE, RAGGED_SHAPE, (1, 7, 1, 3, 2)])
def test_plain_matches_autograd_of_the_plain_forward(shape):
    arrays = _inputs(3, *shape)
    theta, phi, g = (torch.from_numpy(x).requires_grad_() for x in arrays[:3])
    ct = torch.from_numpy(arrays[3])
    ref = torch.autograd.grad(sa_attention_plain(theta, phi, g), (theta, phi, g), ct)
    for name, a, b in zip(("dtheta", "dphi", "dg"), _plain(arrays), ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


def test_plain_bf16_follows_autograd_of_the_plain_forward():
    arrays = _inputs(4, *KERNEL_SHAPE)
    theta, phi, g = (torch.from_numpy(x).bfloat16().requires_grad_() for x in arrays[:3])
    ct = torch.from_numpy(arrays[3]).bfloat16()
    ref = torch.autograd.grad(sa_attention_plain(theta, phi, g), (theta, phi, g), ct)
    for name, a, b in zip(("dtheta", "dphi", "dg"), _plain(arrays, torch.bfloat16), ref):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        assert err <= 3e-2, (name, err)


def test_wrapper_on_cpu_is_the_plain_version():
    arrays = _inputs(5, 2, 64, 16, 8, 12)
    theta, phi, g, ct = (torch.from_numpy(x) for x in arrays)
    before = attn_cuda.launches, attn_cuda.bwd_launches
    got = attn_cuda.sa_attention_bwd(theta, phi, g, ct)
    for a, b in zip(got, sa_attention_bwd_plain(theta, phi, g, ct)):
        assert torch.equal(a, b)
    # Autograd through the CPU wrapper differentiates the plain forward.
    leaves = [t.clone().requires_grad_() for t in (theta, phi, g)]
    grads = torch.autograd.grad(attn_cuda.sa_attention(*leaves), leaves, ct)
    for a, b in zip(grads, got):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (attn_cuda.launches, attn_cuda.bwd_launches) == before   # no kernel on the CPU
