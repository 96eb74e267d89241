"""The port's RBF warp and support sets against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
fused warp runs its Pallas kernel in interpret mode, as tests/test_rbf_pallas.py
does; the port's fused entry takes its plain version on CPU tensors.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpedganspace_tpu.models.support_sets import SupportSets as JSupportSets
from warpedganspace_tpu.ops import rbf as jrbf
from warpedganspace_tpu.ops import rbf_pallas as jrbf_pallas
from warpedganspace_tpu.utils.io import load_pt, save_pt
from warpedganspace_torch.convert.from_jax import support_sets_from_jax
from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.ops import rbf, rbf_cuda

torch.set_num_threads(1)


def _problem(seed, k, two_n, d, n):
    rng = np.random.default_rng(seed)
    sv = rng.standard_normal((k, two_n, d)).astype(np.float32)
    a = rng.standard_normal((k, two_n)).astype(np.float32)
    g = (np.abs(rng.standard_normal((k, two_n))) * 0.3).astype(np.float32)
    z = rng.standard_normal((n, k, d)).astype(np.float32)
    return sv, a, g, z


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_gather_form_matches_jax():
    sv, a, g, _ = _problem(0, 6, 10, 24, 1)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((9, 24)).astype(np.float32)
    idx = rng.integers(0, 6, size=9).astype(np.int32)
    tsv, ta, tg, tz = _t(sv, a, g, z)
    tidx = torch.from_numpy(idx.astype(np.int64))
    # f32 on both sides, small sums: tight.
    tol = dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(rbf.warp_grad(tsv, ta, tg, tz, tidx).numpy(),
                               np.asarray(jrbf.warp_grad(sv, a, g, z, idx)), **tol)
    np.testing.assert_allclose(rbf.warp_grad(tsv, ta, tg, tz, tidx, normalize=False).numpy(),
                               np.asarray(jrbf.warp_grad(sv, a, g, z, idx, normalize=False)),
                               **tol)
    np.testing.assert_allclose(rbf.warp_value(tsv, ta, tg, tz, tidx).numpy(),
                               np.asarray(jrbf.warp_value(sv, a, g, z, idx)), **tol)
    f, d = rbf.warp_value_and_grad(tsv, ta, tg, tz, tidx)
    jf, jd = jrbf.warp_value_and_grad(sv, a, g, z, idx)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **tol)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **tol)
    zn = _problem(2, 6, 10, 24, 4)[3]                          # (N, K, d)
    np.testing.assert_allclose(rbf.warp_grad_all_sets(tsv, ta, tg, torch.from_numpy(zn)).numpy(),
                               np.asarray(jrbf.warp_grad_all_sets(sv, a, g, zn)), **tol)


@pytest.mark.parametrize("k,two_n,d,n", [
    (5, 6, 7, 3),        # unaligned everywhere (the JAX side pads)
    (8, 256, 128, 16),   # production-aligned (SNGAN-like)
    (4, 130, 120, 9),    # BigGAN-like d=120, odd 2N
])
def test_fused_matches_jax_pallas(k, two_n, d, n):
    sv, a, g, z = _problem(0, k, two_n, d, n)
    ref = jrbf_pallas.warp_grad_all_sets_fused(sv, a, g, z)
    got = rbf_cuda.warp_grad_all_sets_fused(*_t(sv, a, g, z))
    # The bound of tests/test_rbf_pallas.py: f32, sums over 2N in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)


def test_kn_bf16_storage_matches_jax():
    sv, a, g, z = _problem(7, 6, 16, 40, 5)
    zkn = np.ascontiguousarray(np.transpose(z, (1, 0, 2)))
    ref = jrbf_pallas.warp_grad_all_sets_kn(
        jrbf_pallas.prepare_warp_sets(sv, a, g, dtype=jnp.bfloat16), zkn)
    ws = rbf_cuda.prepare_warp_sets(*_t(sv, a, g), dtype=torch.bfloat16)
    assert ws.sv.dtype == torch.bfloat16 and ws.svsq.dtype == torch.float32
    got = rbf_cuda.warp_grad_all_sets_kn(ws, torch.from_numpy(zkn)).numpy()
    # Both round sv to bf16; the JAX kernel also rounds z and the weights to
    # bf16 for its MXU dots, the port keeps them f32. So the bound is the
    # bf16-storage one of tests/test_rbf_pallas.py.
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0.05, atol=0.02)
    assert np.mean(np.sum(got * np.asarray(ref), axis=-1)) > 0.999


def test_backward_matches_jax_custom_vjp():
    sv, a, g, z = _problem(3, 4, 10, 24, 6)

    def loss_jax(sv, z):
        return jnp.sum(jnp.cos(jrbf_pallas.warp_grad_all_sets_fused(sv, a, g, z)))

    jsv, jz = jax.grad(loss_jax, argnums=(0, 1))(sv, z)
    tsv, ta, tg, tz = _t(sv, a, g, z)
    tsv.requires_grad_()
    tz.requires_grad_()
    torch.cos(rbf_cuda.warp_grad_all_sets_fused(tsv, ta, tg, tz)).sum().backward()
    # Gradients through exp and a normalisation: looser than the forward.
    np.testing.assert_allclose(tsv.grad.numpy(), np.asarray(jsv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-5)


def test_backend_selection_on_cpu():
    sv, a, g, z = _t(*_problem(4, 3, 8, 16, 2))
    ws = rbf_cuda.prepare_warp_sets(sv, a, g)
    zkn = z.transpose(0, 1).contiguous()
    before = rbf_cuda.launches
    ref = rbf_cuda.warp_grad_all_sets_kn(ws, zkn, backend="torch")
    torch.testing.assert_close(rbf_cuda.warp_grad_all_sets_kn(ws, zkn), ref)
    assert rbf_cuda.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbf_cuda.warp_grad_all_sets_kn(ws, zkn, backend="cuda")
    with pytest.raises(ValueError, match="unknown warp backend"):
        rbf_cuda.warp_grad_all_sets_kn(ws, zkn, backend="pallas")


def test_support_sets_init_and_reference_layout(tmp_path):
    k, n, d = 6, 4, 20
    S = SupportSets(k, n, d, learn_gammas=True, generator=torch.Generator().manual_seed(0))
    sv = S.support_sets.detach()
    norms = torch.linalg.vector_norm(sv, dim=-1)
    radii = 1.0 + 3.0 / k * torch.arange(k, dtype=torch.float32)
    torch.testing.assert_close(norms, radii[:, None].expand(k, 2 * n))
    torch.testing.assert_close(sv[:, 1::2], -sv[:, 0::2])      # interleaved antipodes
    assert S.alphas.detach()[0].tolist() == [1.0, -1.0] * n
    torch.testing.assert_close(S.gammas(), torch.full((k, 2 * n), 1.0 / d))
    assert S.loggamma.requires_grad and not S.alphas.requires_grad

    # The reference layout round-trips through both packages.
    path = osp.join(tmp_path, "support_sets.pt")
    save_pt({key: v.numpy() for key, v in S.to_torch_state_dict().items()}, path)
    JS = JSupportSets(k, n, d, learn_gammas=True)
    jparams = JS.from_torch_state_dict(load_pt(path))
    S2 = SupportSets(k, n, d, learn_gammas=True).from_torch_state_dict(
        support_sets_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    for key, v in S.to_torch_state_dict().items():
        torch.testing.assert_close(S2.to_torch_state_dict()[key], v)
    assert tuple(S.to_torch_state_dict()["SUPPORT_SETS"].shape) == (k, 2 * n * d)

    # Same parameters -> same directions (gather and all-sets forms).
    z = np.random.default_rng(5).standard_normal((3, k, d)).astype(np.float32)
    np.testing.assert_allclose(S.direction_all_sets_fused(torch.from_numpy(z)).detach().numpy(),
                               np.asarray(JS.direction_all_sets(jparams, z)),
                               rtol=2e-5, atol=2e-6)
    idx = np.array([0, 5, 2], np.int32)
    np.testing.assert_allclose(
        S.direction(torch.from_numpy(z[:, 0]), torch.from_numpy(idx.astype(np.int64)))
        .detach().numpy(), np.asarray(JS.direction(jparams, z[:, 0], idx)),
        rtol=2e-5, atol=2e-6)
