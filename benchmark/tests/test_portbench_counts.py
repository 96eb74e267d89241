"""The benchmark's operation and byte counts (``benchmark/counts``)."""
import math

import pytest

from benchmark.counts import generators, step, tails
from benchmark.tests.portbench_tiny import config


@pytest.mark.parametrize("shape, want", [
    ((16, 64, 256, 256, True), 0.4750), ((16, 32, 512, 512, False), 0.4810)])
def test_sg2_tail_bound_matches_the_recorded_sections(shape, want):
    """StyleGAN2's section bounds at the render batch B=16 in bf16, as the
    kernel table of PERF.md records them."""
    assert round(tails.sg2_section_ms(*shape, elem=2), 4) == want


@pytest.mark.parametrize("shape, want", [
    ((16, 64, 128, 128, False), 0.1477), ((16, 32, 256, 256, False), 0.1477),
    ((16, 16, 512, 512, True), 0.1493)])
def test_proggan_tail_bound_matches_the_recorded_sections(shape, want):
    assert round(tails.proggan_section_ms(*shape, elem=2), 4) == want


def test_sg2_frame_count_by_hand():
    """StyleGAN2 at 16x16 with 512 channels, layer by layer."""
    cfg = dict(config("stylegan2-ffhq1024-w"), resolution=16)
    s, c = 512, 512
    conv1 = 2 * (16 * 9 * c * c + s * c + c * c)
    rgb1 = 2 * (16 * 3 * c + s * c)
    total = conv1 + rgb1
    for r in (8, 16):
        up = 2 * ((r // 2) ** 2 * 9 * c * c)             # 9 taps per input pixel
        blur = 2 * (r * r * 8 * c)
        same = 2 * (r * r * 9 * c * c)
        rgb = 2 * (r * r * 3 * c)
        mods = 2 * (s * c) * 3                           # three modulation linears
        demods = 2 * (c * c) * 2
        skip = 2 * (r * r * 8 * 3)
        total += up + blur + same + rgb + mods + demods + skip
    assert generators.frame_flops(cfg) == total


def test_sg2_tail_section_count_is_the_block_count():
    cfg = config("stylegan2-ffhq1024-w")
    for b, c, h, w, _ in generators.sg2_tail_sections(cfg, 1):
        block = generators.sg2_block_flops(cfg, 2 * h)
        assert block["section"] == tails.sg2_section_flops(1, c, h, w)


def test_proggan_frame_count_by_hand():
    """A 16x16 ProgGAN chain: the 4x4 conv reading one tap of the seed, a
    3x3 conv, then up (4 merged taps) and same blocks, and the RGB head."""
    cfg = dict(config("proggan-celebahq1024-z"), channels=[512, 64, 64, 32, 32, 16, 16])
    want = (2 * 16 * 512 * 64 + 2 * 16 * 9 * 64 * 64
            + 2 * 64 * 4 * 64 * 32 + 2 * 64 * 9 * 32 * 32
            + 2 * 256 * 4 * 32 * 16 + 2 * 256 * 9 * 16 * 16
            + 2 * 256 * 3 * 16)
    assert generators.frame_flops(cfg) == want


def test_proggan_tail_sections_of_the_1024_chain():
    cfg = config("proggan-celebahq1024-z")
    assert generators.proggan_tail_sections(cfg, 16) == [
        (16, 64, 128, 128, False), (16, 32, 256, 256, False), (16, 16, 512, 512, True)]
    total = sum(tails.proggan_section_flops(*s) for s in generators.proggan_tail_sections(cfg, 1))
    assert total < generators.frame_flops(cfg)


@pytest.mark.parametrize("name", ["stylegan2-ffhq1024-w", "proggan-celebahq1024-z"])
def test_step_count_adds_up_its_parts(name):
    cfg = config(name)
    parts = step.step_flops_per_sample(cfg)
    total = parts.pop("total")
    assert total == sum(parts.values())
    g = step.generator_flops(cfg)
    assert math.isclose(parts["generator_forwards"] + parts["generator_backward"],
                        3 * g, rel_tol=0, abs_tol=1e-3)
    r = step.resnet18_flops(cfg)
    assert parts["reconstructor"] == 3 * r["total"] - r["conv1"] / 2


def test_resnet18_count_at_224():
    """ResNet-18's 1.81 GMAC at 224x224 with 3 input channels (the usual
    figure), without its 1000-way head."""
    cfg = {"resolution": 224, "reconstructor_channels": 1.5, "num_support_sets": 0}
    macs = (step.resnet18_flops(cfg)["total"] - 2 * 512) / 2
    assert 1.80e9 < macs < 1.83e9
