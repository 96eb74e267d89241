"""The CUDA warp kernel against its plain PyTorch version, on the card.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rbf_cuda.py -m gpu
"""
import numpy as np
import pytest
import torch

from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.ops import rbf, rbf_cuda

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


def _problem(seed, k, two_n, d, n, device):
    rng = np.random.default_rng(seed)
    sv = torch.tensor(rng.standard_normal((k, two_n, d)), dtype=torch.float32, device=device)
    a = torch.tensor(rng.standard_normal((k, two_n)), dtype=torch.float32, device=device)
    g = torch.tensor(np.abs(rng.standard_normal((k, two_n))) * 0.3, dtype=torch.float32,
                     device=device)
    z = torch.tensor(rng.standard_normal((n, k, d)), dtype=torch.float32, device=device)
    return sv, a, g, z


@pytest.mark.parametrize("k,two_n,d,n", [
    (5, 6, 7, 3),        # ragged everywhere
    (8, 256, 128, 16),
    (4, 130, 120, 9),    # d=120, odd chunk tail
    (3, 8, 16, 300),     # many row tiles
])
def test_kernel_matches_plain(cuda, k, two_n, d, n):
    sv, a, g, z = _problem(0, k, two_n, d, n, cuda)
    before = rbf_cuda.launches
    got = rbf_cuda.warp_grad_all_sets_fused(sv, a, g, z, backend="cuda")
    torch.cuda.synchronize()
    assert rbf_cuda.launches == before + 1
    ref = rbf.warp_grad_all_sets(sv, a, g, z)
    # f32 on both sides; the sums over 2N run in another order.
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_production_shape_f32_and_bf16(cuda):
    """K=200, 2N=1024, d=512, R=64 rows (32 codes x +-), sets from the init."""
    gen = torch.Generator().manual_seed(0)
    S = SupportSets(200, 512, 512, learn_gammas=True, generator=gen).to(cuda)
    z = torch.randn((200, 64, 512), generator=gen).to(cuda)  # |z| ~ sqrt(d)
    with torch.no_grad():
        ws = rbf_cuda.prepare_warp_sets(S.support_sets, S.alphas, S.gammas())
        got = rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")
        ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
        # Unit vectors; f32 sums over 2N=1024 terms in another order.
        assert float((got - ref).abs().max()) <= 1e-4
        ws16 = rbf_cuda.prepare_warp_sets(S.support_sets, S.alphas, S.gammas(), torch.bfloat16)
        got16 = rbf_cuda.warp_grad_all_sets_kn(ws16, z, backend="cuda")
        # bf16 set storage: the bound of tests/test_rbf_pallas.py.
        assert float((got16 * got).sum(-1).mean()) > 0.999


def test_backward_is_plain_vjp(cuda):
    sv, a, g, z = _problem(3, 4, 10, 24, 6, cuda)
    sv1, z1 = sv.clone().requires_grad_(), z.clone().requires_grad_()
    sv2, z2 = sv.clone().requires_grad_(), z.clone().requires_grad_()
    torch.cos(rbf_cuda.warp_grad_all_sets_fused(sv1, a, g, z1, backend="cuda")).sum().backward()
    torch.cos(rbf.warp_grad_all_sets(sv2, a, g, z2)).sum().backward()
    torch.testing.assert_close(sv1.grad, sv2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(z1.grad, z2.grad, rtol=1e-4, atol=1e-5)
