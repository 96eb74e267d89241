"""The CUDA tail kernel against its plain PyTorch version, on the card.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_proggan_tail_cuda.py -m gpu
"""
import pytest
import torch

from warpedganspace_torch.ops import proggan_tail_cuda
from warpedganspace_torch.ops.proggan_tail import TAIL_CHANNELS, fused_section_plain

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # f32 comparisons: keep the plain version's convolutions out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(seed, b, c, h, w, head, device, dtype=torch.float32):
    """Unit-scale input; weights scaled so that every conv output is of unit
    scale too; WScale scales != 1 and random biases, so that a wrong WScale or
    a mid border computed instead of zeroed shows."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std=1.0):
        return std * torch.randn(shape, generator=gen)

    ops = [normal(b, 2 * c, h, w),
           normal(c, 2 * c, 3, 3, std=(18 * c) ** -0.5), normal(c, std=0.3), torch.tensor([1.3]),
           normal(c, c, 3, 3, std=(9 * c) ** -0.5), normal(c, std=0.3), torch.tensor([0.8])]
    hd = None
    if head:
        hd = tuple(t.to(device=device, dtype=dtype) for t in
                   (normal(3, c, 1, 1, std=c ** -0.5), normal(3, std=0.3), torch.tensor([1.1])))
    return [t.to(device=device, dtype=dtype) for t in ops], hd


# f32: the split-precision design's products (3xTF32, about 22 bits each) in
# another order, sums of up to 4 * 128 and 9 * 64 of them, and merged up-conv
# taps (tests/test_torch_proggan_tail_f32_split_numerics.py emulates it: 4.4e-6
# at worst, at the whole 1024^2 section with the head). bf16: the tensor-core
# design rounds the normalised input, the merged taps and the normalised mid
# tile to bf16 (the section with the RGB head carries them as bf16 hi + lo
# pairs, so there only the output is rounded), where the plain version rounds
# every intermediate. So it is held
# to the plain version in f32 on the same rounded operands within 3e-2 (the
# output's half ulp below 8, 2^-6, plus about as much from the intermediates:
# tests/test_torch_tail_tc_numerics.py emulates those roundings) and no farther
# from it than the plain bf16 version is.
def _check(ops, head, vs_plain16=True):
    before = proggan_tail_cuda.launches
    got = proggan_tail_cuda.fused_section(*ops, head=head)
    torch.cuda.synchronize()
    assert proggan_tail_cuda.launches == before + 1
    ops32 = [t.float() for t in ops]
    head32 = None if head is None else tuple(t.float() for t in head)
    ref = fused_section_plain(*ops32, head=head32)
    b, c2, h, w = ops[0].shape
    assert got.dtype == ops[0].dtype
    assert tuple(got.shape) == (b, 3 if head else c2 // 2, 2 * h, 2 * w) == tuple(ref.shape)
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - ref).abs().max())
    if got.dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 3e-2, err
        if vs_plain16:
            plain16 = fused_section_plain(*ops, head=head).float()
            assert err <= float((plain16 - ref).abs().max()) + 1e-6
    return err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,r,head", [(64, 128, False), (32, 256, False), (16, 512, True)])
def test_full_width_sections(cuda, dtype, c, r, head):
    """The three sections of the 1024^2 generator: 128 -> 64 at 256^2,
    64 -> 32 at 512^2, 32 -> 16 at 1024^2 with the RGB head."""
    _check(*_problem(0, 2, c, r, r, head, cuda, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (1, 1),       # a 2 x 2 output: every mid pixel touches the border
    (3, 5),       # odd, one ragged tile
    (8, 8),       # exactly one tile
    (9, 23),      # one row and 14 columns past a tile
    (17, 4),      # three tile rows, the last one of 2 rows
])
def test_border_and_ragged_shapes(cuda, dtype, head, c, h, w):
    _check(*_problem(1, 3, c, h, w, head, cuda, dtype))


def test_zero_input_gives_the_bias_path(cuda):
    """A zero image (the padded tail of the last render batch): PixelNorm keeps
    it zero, so the output is what the biases alone give, and finite."""
    ops, head = _problem(2, 1, 16, 8, 8, True, cuda)
    ops[0].zero_()
    assert _check(ops, head) <= 1e-5


@pytest.mark.parametrize("head", [False, True])
def test_bf16_repeats_are_bit_equal(cuda, head):
    """The tensor-core design sums in a fixed order: one call's bits again."""
    ops, hd = _problem(7, 2, 32, 13, 11, head, cuda, torch.bfloat16)
    first = proggan_tail_cuda.fused_section(*ops, head=hd)
    again = proggan_tail_cuda.fused_section(*ops, head=hd)
    assert torch.equal(first, again)
    assert proggan_tail_cuda.design(torch.bfloat16).startswith("tensor cores")
    assert proggan_tail_cuda.design(torch.float32) == "tensor cores (mma.sync m16n8k8, 3xTF32)"


@pytest.mark.parametrize("head", [False, True])
def test_bf16_c16_full_1024_section(cuda, head):
    """C = 16 at the whole 512^2 -> 1024^2 section, the widest grid of tiles
    and the narrowest products (two n8 tiles a warp)."""
    _check(*_problem(8, 1, 16, 512, 512, head, cuda, torch.bfloat16))


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (13, 11),     # 26 x 22: the last tiles' parity groups cut at the edge
    (7, 29),      # 14 x 58: one short tile row, widths not a multiple of 8
    (25, 3),      # 50 x 6: a single narrow tile column
])
def test_bf16_parity_groups_at_ragged_edges(cuda, head, c, h, w):
    _check(*_problem(9, 2, c, h, w, head, cuda, torch.bfloat16))


@pytest.mark.parametrize("head", [False, True])
def test_bf16_zero_input_gives_the_bias_path(cuda, head):
    """A zero image in bf16: the output is what the biases alone give."""
    ops, hd = _problem(10, 2, 32, 8, 8, head, cuda, torch.bfloat16)
    ops[0].zero_()
    _check(ops, hd, vs_plain16=False)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
def test_f32_repeats_are_bit_equal(cuda, c, head):
    """The split-precision design sums in a fixed order: one call's bits again."""
    ops, hd = _problem(11, 2, c, 13, 11, head, cuda)
    first = proggan_tail_cuda.fused_section(*ops, head=hd)
    again = proggan_tail_cuda.fused_section(*ops, head=hd)
    assert torch.equal(first, again)


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (13, 11),     # 26 x 22: the last tiles' parity groups cut at the edge
    (7, 29),      # 14 x 58: one short tile row, widths not a multiple of 8
    (25, 3),      # 50 x 6: a single narrow tile column
])
def test_f32_parity_groups_at_ragged_edges(cuda, head, c, h, w):
    _check(*_problem(9, 2, c, h, w, head, cuda))


@pytest.mark.parametrize("c,r,head", [(64, 128, False), (32, 256, False), (16, 512, True)])
def test_f32_against_the_cuda_core_design(cuda, c, r, head):
    """The full-width sections through the split-precision design and through
    the CUDA-core design it replaced (its own C entry): each within 1e-4 of
    the plain section, so within 2e-4 of each other."""
    from warpedganspace_torch.ops.proggan_tail_cuda_cores import cc_section

    ops, hd = _problem(13, 2, c, r, r, head, cuda)
    _check(ops, hd)
    got = proggan_tail_cuda.fused_section(*ops, head=hd)
    ref = cc_section(*ops, head=hd)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 2e-4


# The tensor cores round their f32 sums toward zero; the design adds each
# weight chunk's products into round-to-nearest f32 sums. The CPU emulation
# (tests/test_torch_proggan_tail_f32_split_numerics.py) puts the signed mean
# error against float64 at -1e-7 to +4e-8 with those flushes and at -3.9e-6
# at C = 64 with one chain an accumulator, the plain f32 section's at about
# 1e-8: the bound sits between them.
SME_BOUND = 1e-6


@pytest.mark.parametrize("c,r,head", [(64, 128, False), (32, 256, False), (16, 512, True)])
def test_f32_signed_mean_error_against_float64(cuda, c, r, head):
    """The mean of (kernel - float64) along the sign of the float64 section,
    over its mean magnitude, at the full-width sections: a truncation bias
    that the max abs gate would miss."""
    ops, hd = _problem(14, 2, c, r, r, head, cuda)
    got = proggan_tail_cuda.fused_section(*ops, head=hd)
    with torch.no_grad():
        ref = fused_section_plain(*[t.double() for t in ops],
                                  head=None if hd is None else tuple(t.double() for t in hd))
    sme = float(((got.double() - ref) * torch.sign(ref)).sum()) / float(ref.abs().sum())
    assert abs(sme) <= SME_BOUND, sme


def test_limits_raise(cuda):
    ops, head = _problem(3, 1, 8, 4, 4, True, cuda)
    with pytest.raises(ValueError, match="C in"):
        proggan_tail_cuda.fused_section(*ops, head=head)
    ops, head = _problem(3, 1, 16, 4, 4, True, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        proggan_tail_cuda.fused_section(ops[0].transpose(2, 3), *ops[1:], head=head)
    with pytest.raises(TypeError, match="share one dtype"):
        proggan_tail_cuda.fused_section(ops[0], ops[1].bfloat16(), *ops[2:], head=head)
    with pytest.raises(ValueError, match=r"\(3, 16, 1, 1\)"):
        proggan_tail_cuda.fused_section(*ops, head=(head[0][:, :8].contiguous(),) + head[1:])
    with pytest.raises(ValueError, match="same"):
        proggan_tail_cuda.fused_section(*ops[:4], ops[4][:, :8].contiguous(), *ops[5:])
    before = proggan_tail_cuda.launches
    empty = proggan_tail_cuda.fused_section(ops[0][:0], *ops[1:], head=head)
    assert tuple(empty.shape) == (0, 3, 8, 8) and proggan_tail_cuda.launches == before


def test_backward_is_plain_vjp(cuda):
    ops, head = _problem(4, 2, 16, 5, 7, True, cuda)
    leaves1 = [t.requires_grad_() for t in ops + list(head)]
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves1]
    torch.cos(proggan_tail_cuda.fused_section(*leaves1[:7], head=leaves1[7:])).sum().backward()
    torch.cos(fused_section_plain(*leaves2[:7], head=leaves2[7:])).sum().backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-4)


def test_generator_reaches_the_kernel(cuda):
    """A small ProgGAN's forward launches one kernel per tail section on the
    card and agrees with the same generator on the CPU (plain versions)."""
    from warpedganspace_torch.models.proggan import ProgGANGenerator

    gen = ProgGANGenerator(dim_z=128, channels=[128, 128, 128, 128, 128, 64, 64, 32, 32, 16, 16],
                           generator=torch.Generator().manual_seed(5))
    rng = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for block in list(gen.blocks) + [gen.out]:
            block.weight.mul_(block.weight[0].numel() ** -0.5 / 0.02)   # unit-scale outputs
            block.scale.fill_(0.9)
            block.bias.copy_(0.2 * torch.randn(block.bias.shape, generator=rng))
        z = torch.randn((2, 128), generator=rng)
        ref = gen(z)
        before = proggan_tail_cuda.launches
        got = gen.to(cuda)(z.to(cuda))
        torch.cuda.synchronize()
    assert proggan_tail_cuda.launches == before + 3
    assert tuple(got.shape) == (2, 3, 64, 64)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
