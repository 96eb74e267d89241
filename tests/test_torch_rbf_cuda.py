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
from warpedganspace_torch.ops import rbf, rbf_cuda, rbf_cuda_cores

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


_SETS = {}


def _sets(k, two_n, d, device):
    """K sets as the init makes them (dipoles, radii in [1, 4), gamma 1/d),
    made on the card from a seed and kept for the module."""
    key = (k, two_n, d)
    if key not in _SETS:
        gen = torch.Generator(device=device).manual_seed(k * 7919 + two_n * 31 + d)
        half = torch.randn((k, two_n // 2, d), generator=gen, device=device)
        sv = torch.stack([half, -half], dim=2).reshape(k, two_n, d)
        radii = 1.0 + 3.0 / k * torch.arange(k, device=device, dtype=torch.float32)
        sv = radii[:, None, None] * sv / torch.linalg.vector_norm(sv, dim=-1, keepdim=True)
        a = torch.tensor([1.0, -1.0], device=device).repeat(two_n // 2).expand(k, two_n)
        g = torch.full((k, two_n), 1.0 / d, device=device)
        _SETS[key] = (sv.contiguous(), a.contiguous(), g)
    return _SETS[key]


def _check_shape(cuda, k, two_n, d, rows, dtype):
    sv, a, g = _sets(k, two_n, d, cuda)
    gen = torch.Generator(device=cuda).manual_seed(rows * 131 + d)
    z = torch.randn((k, rows, d), generator=gen, device=cuda)        # |z| ~ sqrt(d)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g, dtype)
    before = rbf_cuda.launches
    got = rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")
    torch.cuda.synchronize()
    assert rbf_cuda.launches == before + 1   # one per call, whatever the splits
    ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    # Unit vectors; split-precision tensor-core products against f32 sums.
    assert float((got - ref).abs().max()) <= 1e-4


ROWS = [1, 2, 8, 12, 16, 17, 64, 65]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [120, 500, 512])
@pytest.mark.parametrize("two_n", [512, 1000, 1024])
@pytest.mark.parametrize("rows", ROWS)
def test_one_set(cuda, rows, two_n, d, dtype):
    """K=1: the plan splits 2N into the most runs."""
    _check_shape(cuda, 1, two_n, d, rows, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [120, 500, 512])
@pytest.mark.parametrize("rows", ROWS)
def test_production_sets(cuda, rows, d, dtype):
    """K=200 sets of 2N=1024, as the ProgGAN and StyleGAN2 experiments have."""
    _check_shape(cuda, 200, 1024, d, rows, dtype)


def test_biggan_shape(cuda):
    """BigGAN's experiment: K=120, 2N=512, d=120, the eval pool's R=8."""
    for dtype in DTYPES:
        _check_shape(cuda, 120, 512, 120, 8, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_zero_weight_set(cuda, dtype):
    """A set with all ag = 0 has a zero gradient, which normalises to NaN in
    the kernel as in the plain version; the other sets are untouched."""
    sv, a, g = _sets(3, 64, 40, cuda)
    a = a.clone()
    a[1] = 0.0
    z = torch.randn((3, 5, 40), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g, dtype)
    got = rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")
    ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(ref[1]).all())
    for kk in (0, 2):
        assert float((got[kk] - ref[kk]).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("k,rows", [(200, 2), (1, 65)])
def test_split_reduction_repeats_bit_equal(cuda, k, rows, dtype):
    """The runs' partial sums are added in a fixed order: the same bits on
    every call."""
    sv, a, g = _sets(k, 1024, 512, cuda)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g, dtype)
    slots = rbf_cuda._slots(rbf_cuda.build(), sv.device, dtype == torch.bfloat16, 512)
    assert rbf_cuda.plan(k, 1024, rows, 512, slots, ws.sv.element_size()).splits > 1
    z = torch.randn((k, rows, 512), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    first = rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda")
    for _ in range(3):
        assert torch.equal(rbf_cuda.warp_grad_all_sets_kn(ws, z, backend="cuda"), first)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,k,two_n,d,rows", rbf_cuda_cores.SHAPES[1:])
def test_cuda_core_design_at_the_timed_shapes(cuda, label, k, two_n, d, rows, dtype):
    """The CUDA-core design the tensor-core kernel replaced, through its own
    C entry (``ops/rbf_cuda_cores.py``), at the shapes ``chip_smoke.py`` and
    ``scripts/ablate_warp_cuda.py`` time it: within the kernel's 1e-4 of the
    plain version, and counting no launch of the shipped kernel."""
    sv, a, g = _sets(k, two_n, d, cuda)
    z = torch.randn((k, rows, d), generator=torch.Generator(device=cuda).manual_seed(rows),
                    device=cuda)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g, None if dtype == torch.float32 else dtype)
    before = rbf_cuda.launches
    got = rbf_cuda_cores.cuda_cores()(ws, z)
    torch.cuda.synchronize()
    assert rbf_cuda.launches == before
    ref = rbf_cuda._torch_kn(ws.sv, ws.g, ws.ag, ws.svsq, z)
    assert float((got - ref).abs().max()) <= 1e-4


def test_launch_checks_raise(cuda):
    sv, a, g = _sets(2, 16, 520, cuda)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g)
    with pytest.raises(ValueError, match="d <= 512"):
        rbf_cuda.warp_grad_all_sets_kn(ws, torch.zeros((2, 3, 520), device=cuda), backend="cuda")
    sv, a, g = _sets(2, 16, 24, cuda)
    ws = rbf_cuda.prepare_warp_sets(sv, a, g)
    with pytest.raises(TypeError, match="z must be float32"):
        rbf_cuda.warp_grad_all_sets_kn(ws, torch.zeros((2, 3, 24), device=cuda,
                                                       dtype=torch.float64), backend="cuda")


def test_backward_is_plain_vjp(cuda):
    sv, a, g, z = _problem(3, 4, 10, 24, 6, cuda)
    sv1, z1 = sv.clone().requires_grad_(), z.clone().requires_grad_()
    sv2, z2 = sv.clone().requires_grad_(), z.clone().requires_grad_()
    torch.cos(rbf_cuda.warp_grad_all_sets_fused(sv1, a, g, z1, backend="cuda")).sum().backward()
    torch.cos(rbf.warp_grad_all_sets(sv2, a, g, z2)).sum().backward()
    torch.testing.assert_close(sv1.grad, sv2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(z1.grad, z2.grad, rtol=1e-4, atol=1e-5)
