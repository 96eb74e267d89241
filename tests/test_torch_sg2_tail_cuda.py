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


# f32: sums of up to 9 * 128 unit-scale products in another order, and the
# polyphase up-conv weights composed in f32. bf16: the kernel keeps f32
# between its stages where the plain version rounds every intermediate, so it
# is held to the plain version in f32 on the same rounded operands, within the
# rounding of its bf16 outputs (values below 8, half an ulp of 2^-5, doubled).
def _check(ops, want_x2):
    before = sg2_tail_cuda.launches
    got = sg2_tail_cuda.fused_section(*ops, want_x2=want_x2)
    torch.cuda.synchronize()
    assert sg2_tail_cuda.launches == before + 1
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
