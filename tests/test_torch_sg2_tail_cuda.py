"""The CUDA StyleGAN2 tail kernel against its plain PyTorch version, on the card.

These cases need an NVIDIA card with ``nvcc``; elsewhere they skip. The file
imports no JAX, so on a machine without it run it on its own, past the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sg2_tail_cuda.py -m gpu
"""
import pytest
import torch

from warpedganspace_torch.ops import sg2_tail_cuda
from warpedganspace_torch.ops.sg2_tail import TAIL_CHANNELS, fused_section_plain
from warpedganspace_torch.ops.sg2_tail_polyphase import polyphase_section

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


def _problem(seed, b, c, h, w, device, dtype=torch.float32):
    """Unit-scale input, weights scaled so that every conv output has a scale
    of one half (every output then stays below 8 in magnitude), and every
    other operand away from the random init: noise
    weights != 0, random biases, s and d away from 1 (the init's zero noise
    weight and bias would hide a dropped term, and a mid border computed
    instead of zeroed)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen)

    ops = [rnd(b, 2 * c, h, w), rnd(c, 2 * c, 3, 3, std=0.5 * (18 * c) ** -0.5),
           rnd(c, c, 3, 3, std=0.5 * (9 * c) ** -0.5), rnd(3, c, 1, 1, std=0.5 * c ** -0.5),
           rnd(b, 2 * c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3), rnd(b, c, mean=1.0, std=0.2),
           rnd(b, c, mean=1.0, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(0.7), rnd(c, std=0.3),
           rnd(1, 1, 2 * h, 2 * w), torch.tensor(-0.4), rnd(c, std=0.3), rnd(3, std=0.3)]
    return [t.to(device=device, dtype=dtype) for t in ops]


# f32: the split-precision design's products (3xTF32, about 22 bits each) in
# another order, sums of up to 4 * 128 and 9 * 64 of them, and the blur after
# * d1 where the plain version blurs before it
# (tests/test_torch_sg2_tail_f32_split_numerics.py emulates it: 2.4e-6 at
# worst). bf16: the wgmma design rounds x * s1 and the mid tile to bf16 (the
# polyphase design kept for comparison the composed up-conv weights too)
# where the plain version rounds every intermediate, so it is held to the
# plain version in f32 on the same rounded operands within 3e-2: the outputs'
# half ulp below 8, 2^-6, plus about as much from the intermediates
# (tests/test_torch_tail_tc_numerics.py emulates those roundings).
def _check(ops, want_x2, section=None):
    """``section``: a design kept for comparison, which counts no launch;
    by default the kernel, which counts one under its design."""
    before = sg2_tail_cuda.launches
    by_design = dict(sg2_tail_cuda.launches_by_design)
    got = (section or sg2_tail_cuda.fused_section)(*ops, want_x2=want_x2)
    torch.cuda.synchronize()
    counted = section is None
    assert sg2_tail_cuda.launches == before + counted
    key = sg2_tail_cuda.DESIGN_KEYS[ops[0].dtype]
    assert sg2_tail_cuda.launches_by_design == {**by_design, key: by_design[key] + counted}
    ref = fused_section_plain(*[t.float() for t in ops], want_x2=want_x2)
    got, ref = (got, ref) if want_x2 else ((got,), (ref,))
    b, c2, h, w = ops[0].shape
    shapes = [(b, 3, 2 * h, 2 * w), (b, c2 // 2, 2 * h, 2 * w)]
    tol = 1e-4 if ops[0].dtype == torch.float32 else 3e-2
    errs = []
    for g, r, shape in zip(got, ref, shapes):
        assert g.dtype == ops[0].dtype
        assert tuple(g.shape) == shape == tuple(r.shape)
        assert bool(torch.isfinite(g).all())
        errs.append(float((g.float() - r).abs().max()))
        assert errs[-1] <= tol, errs
    return max(errs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_full_width_sections(cuda, dtype, c, r, want_x2):
    """StyleGAN2-1024's two sections: 128 -> 64 channels at 512^2 (x2 goes on
    to the next block), 64 -> 32 at 1024^2 (only the RGB is written)."""
    _check(_problem(0, 2, c, r, r, cuda, dtype), want_x2)


@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_path_shapes(cuda, c, r, want_x2):
    """What the StyleGAN2 path gives the kernel: a bf16 render batch of 16 and
    sample_gan's one f32 code."""
    _check(_problem(1, 16, c, r, r, cuda, torch.bfloat16), want_x2)
    _check(_problem(1, 1, c, r, r, cuda, torch.float32), want_x2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (1, 1),       # a 2 x 2 output: every mid pixel touches the border
    (2, 2),       # 4 x 4
    (13, 7),      # odd and ragged: 26 x 14, a tile row and column cut
    (8, 8),       # exactly one tile
    (17, 4),      # three tile rows, the last one of 2 rows
])
def test_border_and_ragged_shapes(cuda, dtype, want_x2, c, h, w):
    _check(_problem(2, 3, c, h, w, cuda, dtype), want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
def test_bf16_repeats_are_bit_equal(cuda, want_x2):
    """The tensor-core design sums in a fixed order: one call's bits again."""
    ops = _problem(7, 2, 32, 13, 11, cuda, torch.bfloat16)
    first = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    again = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    first, again = (first, again) if want_x2 else ((first,), (again,))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert sg2_tail_cuda.design(torch.bfloat16).startswith("tensor cores")
    assert sg2_tail_cuda.design(torch.float32) == (
        "tensor cores (mma.sync m16n8k8, 3xTF32), transposed conv + blur")


@pytest.mark.parametrize("want_x2", [True, False])
def test_bf16_c16_full_1024_section(cuda, want_x2):
    """C = 16 at a whole 512^2 -> 1024^2 section, the widest grid of tiles and
    the narrowest products (two n8 tiles a warp)."""
    _check(_problem(8, 1, 16, 512, 512, cuda, torch.bfloat16), want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (13, 11),     # 26 x 22: the last tiles' parity groups cut at the edge
    (7, 29),      # 14 x 58: one short tile row, widths not a multiple of 8
    (25, 3),      # 50 x 6: a single narrow tile column
])
def test_bf16_parity_groups_at_ragged_edges(cuda, want_x2, c, h, w):
    _check(_problem(9, 2, c, h, w, cuda, torch.bfloat16), want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
def test_bf16_zero_input_gives_the_bias_path(cuda, want_x2):
    """A zero image in bf16: the mid tile is the noise and bias alone."""
    ops = _problem(10, 2, 32, 8, 8, cuda, torch.bfloat16)
    ops[0].zero_()
    _check(ops, want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
def test_f32_repeats_are_bit_equal(cuda, want_x2):
    """The split-precision design sums in a fixed order: one call's bits again."""
    ops = _problem(11, 2, 64, 13, 11, cuda)
    first = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    again = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    first, again = (first, again) if want_x2 else ((first,), (again,))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
def test_f32_zero_input_gives_the_bias_path(cuda, c, want_x2):
    """A zero image in f32: T is 0, and the mid tile is the noise and bias alone."""
    ops = _problem(12, 2, c, 8, 8, cuda)
    ops[0].zero_()
    _check(ops, want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [
    (13, 11),     # 26 x 22: the last tiles' parity groups cut at the edge
    (7, 29),      # 14 x 58: one short tile row, widths not a multiple of 8
    (25, 3),      # 50 x 6: a single narrow tile column
])
def test_f32_parity_groups_at_ragged_edges(cuda, want_x2, c, h, w):
    _check(_problem(9, 2, c, h, w, cuda), want_x2)


@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_f32_against_the_cuda_core_design(cuda, c, r, want_x2):
    """The full-width sections through the split-precision design and through
    the CUDA-core design it replaced (its own C entry): each within 1e-4 of
    the plain section, so within 2e-4 of each other."""
    from warpedganspace_torch.ops.sg2_tail_cuda_cores import cc_section

    ops = _problem(13, 2, c, r, r, cuda)
    _check(ops, want_x2)
    got = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    ref = cc_section(*ops, want_x2=want_x2)
    got, ref = (got, ref) if want_x2 else ((got,), (ref,))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        assert float((a - b).abs().max()) <= 2e-4


# The tensor cores round their f32 sums toward zero; the design adds its
# accumulators into round-to-nearest f32 sums every 2 weight chunks. The CPU
# emulation (tests/test_torch_sg2_tail_f32_split_numerics.py) puts the signed
# mean error against float64 at -4e-8 to -2e-7 with those flushes and at
# -2e-6 to -2.8e-6 at C = 64 with one chain a parity group, the plain f32
# section's at about -2e-8: the bound sits between them.
SME_BOUND = 1e-6


@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_f32_signed_mean_error_against_float64(cuda, c, r, want_x2):
    """The mean of (kernel - float64) along the sign of the float64 section,
    over its mean magnitude, at the full-width sections: a truncation bias
    that the max abs gate would miss."""
    ops = _problem(14, 2, c, r, r, cuda)
    got = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    with torch.no_grad():
        ref = fused_section_plain(*[t.double() for t in ops], want_x2=want_x2)
    got, ref = (got, ref) if want_x2 else ((got,), (ref,))
    num = sum(float(((a.double() - b) * torch.sign(b)).sum()) for a, b in zip(got, ref))
    den = sum(float(b.abs().sum()) for b in ref)
    assert abs(num / den) <= SME_BOUND, num / den


def test_limits_raise(cuda):
    ops = _problem(3, 1, 8, 4, 4, cuda)
    with pytest.raises(ValueError, match="C in"):
        sg2_tail_cuda.fused_section(*ops)
    ops = _problem(3, 1, 16, 4, 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sg2_tail_cuda.fused_section(ops[0].transpose(2, 3), *ops[1:])
    with pytest.raises(TypeError, match="share one dtype"):
        sg2_tail_cuda.fused_section(ops[0], ops[1].bfloat16(), *ops[2:])
    with pytest.raises(ValueError, match="one device"):
        sg2_tail_cuda.fused_section(*ops[:5], ops[5].cpu(), *ops[6:])
    with pytest.raises(ValueError, match="n1"):
        sg2_tail_cuda.fused_section(*ops[:9], ops[9][..., :4].contiguous(), *ops[10:])
    before = sg2_tail_cuda.launches
    ops0 = [ops[0][:0]] + ops[1:4] + [t[:0] for t in ops[4:9]] + ops[9:]
    rgb, x2 = sg2_tail_cuda.fused_section(*ops0)
    assert tuple(rgb.shape) == (0, 3, 8, 8) and tuple(x2.shape) == (0, 16, 8, 8)
    assert sg2_tail_cuda.launches == before


@pytest.mark.parametrize("want_x2", [True, False])
def test_backward_is_plain_vjp(cuda, want_x2):
    ops = _problem(4, 2, 16, 5, 7, cuda)
    leaves1 = [t.requires_grad_() for t in ops]
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves1]

    def loss(out):
        outs = out if want_x2 else (out,)
        return sum(torch.cos(o).sum() for o in outs)

    loss(sg2_tail_cuda.fused_section(*leaves1, want_x2=want_x2)).backward()
    loss(fused_section_plain(*leaves2, want_x2=want_x2)).backward()
    for a, b in zip(leaves1, leaves2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-4)


def test_generator_reaches_the_kernel(cuda):
    """A small StyleGAN2 (512^2, channel multiplier 1: two tail sections, C = 64
    then C = 32) launches the kernel twice per forward on the card and agrees
    with the same generator on the CPU (plain versions)."""
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    gen = StyleGAN2Generator(resolution=512, n_mlp=2, channel_multiplier=1,
                             generator=torch.Generator().manual_seed(5)).eval()
    rng = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for blk in [gen.conv1] + list(gen.convs):
            blk.noise_weight.fill_(0.3)
            blk.act_bias.copy_(0.1 * torch.randn(blk.act_bias.shape, generator=rng))
        for rgb in [gen.to_rgb1] + list(gen.to_rgbs):
            rgb.bias.copy_(0.1 * torch.randn(3, generator=rng))
        z = torch.randn((2, 512), generator=rng)
        ref = gen.apply(z)
        before = sg2_tail_cuda.launches
        got = gen.to(cuda).apply(z.to(cuda))
        torch.cuda.synchronize()
    assert sg2_tail_cuda.launches == before + 2
    assert tuple(got.shape) == (2, 3, 512, 512)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("b", [1, 12, 16])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
def test_bf16_batches_at_ragged_shapes(cuda, c, b, want_x2):
    """The wgmma design at the sampled code's B = 1, the training step's 12
    and the render batch's 16, on a ragged 26 x 22 output."""
    _check(_problem(15, b, c, 13, 11, cuda, torch.bfloat16), want_x2)


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
def test_bf16_ragged_width_over_several_tiles_a_block(cuda, c, want_x2):
    """An input width that is not a multiple of 8 (the noise copied element by
    element into the double buffer) with more tiles than the grid's resident
    blocks: 16 x 8 x 8 = 1024 tiles of a 122 x 118 output, so each persistent
    block hands its buffers from one tile to the next."""
    _check(_problem(22, 16, c, 61, 59, cuda, torch.bfloat16), want_x2)


@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_bf16_training_batch_sections(cuda, c, r, want_x2):
    """StyleGAN2-1024's two sections at the training step's batch of 12."""
    _check(_problem(16, 12, c, r, r, cuda, torch.bfloat16), want_x2)


@pytest.mark.parametrize("c", TAIL_CHANNELS)
def test_bf16_repeats_are_bit_equal_at_each_width(cuda, c):
    """Each width's products in a fixed order: one call's bits again, x2 too."""
    ops = _problem(17, 3, c, 9, 14, cuda, torch.bfloat16)
    first = sg2_tail_cuda.fused_section(*ops)
    again = sg2_tail_cuda.fused_section(*ops)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("c", [32, 64])
def test_bf16_section_replays_in_a_cuda_graph(cuda, c):
    """One section captured in a CUDA graph (the training path's
    --steps-per-call captures it) and replayed: the eager call's bits, and
    again after the input changed in place."""
    ops = _problem(18, 4, c, 24, 20, cuda, torch.bfloat16)
    eager = sg2_tail_cuda.fused_section(*ops)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sg2_tail_cuda.fused_section(*ops)
    torch.cuda.current_stream().wait_stream(side)
    before = sg2_tail_cuda.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sg2_tail_cuda.fused_section(*ops)
    assert sg2_tail_cuda.launches == before + 1     # the capture, not its replays
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    ops[0].copy_(_problem(19, 4, c, 24, 20, cuda, torch.bfloat16)[0])
    graph.replay()
    eager = sg2_tail_cuda.fused_section(*ops)
    torch.cuda.synchronize()
    assert sg2_tail_cuda.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_bf16_generator_launches_the_wgmma_design(cuda):
    """The small StyleGAN2 of ``test_generator_reaches_the_kernel`` in bf16:
    both tail launches of a forward go through the wgmma design, and the
    frames stay within bf16's reach of the float32 forward on the card."""
    from warpedganspace_torch.models.api import cast_params_bf16
    from warpedganspace_torch.models.stylegan2 import StyleGAN2Generator

    gen = StyleGAN2Generator(resolution=512, n_mlp=2, channel_multiplier=1,
                             generator=torch.Generator().manual_seed(5)).eval().to(cuda)
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(6)).to(cuda)
    with torch.no_grad():
        ref = gen.apply(z)
        by_design = dict(sg2_tail_cuda.launches_by_design)
        got = cast_params_bf16(gen).apply(z.bfloat16())
        torch.cuda.synchronize()
    assert sg2_tail_cuda.launches_by_design["wgmma"] == by_design["wgmma"] + 2
    assert sg2_tail_cuda.launches_by_design["split_tf32"] == by_design["split_tf32"]
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    rel = float((got.float() - ref).norm() / ref.norm())
    assert rel <= 0.05, rel


@pytest.mark.parametrize("want_x2", [True, False])
@pytest.mark.parametrize("c", TAIL_CHANNELS)
@pytest.mark.parametrize("h,w", [(13, 11), (8, 8)])
def test_bf16_polyphase_comparison_design(cuda, c, h, w, want_x2):
    """The mma.sync design that the wgmma design replaced, through its own C
    entry: within the same bound of the plain section, counting no launch."""
    _check(_problem(20, 2, c, h, w, cuda, torch.bfloat16), want_x2, section=polyphase_section)


@pytest.mark.parametrize("c,r,want_x2", [(64, 256, True), (32, 512, False)])
def test_bf16_polyphase_full_width_sections(cuda, c, r, want_x2):
    """Both bf16 designs at StyleGAN2-1024's two sections, B = 4."""
    ops = _problem(21, 4, c, r, r, cuda, torch.bfloat16)
    _check(ops, want_x2)
    _check(ops, want_x2, section=polyphase_section)
