"""The port's BigGAN generator against the benchmark's plain reference
(``benchmark/reference/biggan.py``) on the CPU, at a tiny size with an
attention block, and the generator's spans under ``torch.profiler``.

The weights are the benchmark's (``benchmark/families/biggan.py``): the
reference's ``G_ema.pth`` layout with ``u0`` vectors, standing batch-norm
statistics and a nonzero attention gamma, loaded into the port through its
own converter (``convert/biggan.py``), which folds spectral norm in numpy
while the reference folds it in torch."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import inputs
from benchmark.families import biggan as family
from benchmark.reference import quant
from benchmark.tests.portbench_tiny import config
from warpedganspace_torch.models.api import cast_params_bf16
from warpedganspace_torch.traverse.engine import iter_rendered_u8

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = dict(config("biggan128-239-z"), **family.TINY)
SEEDS = (1, 2, 3)


def weights(seed):
    return family.make_weights(CFG, inputs.generator(seed, "generator", CPU), CPU)


def codes_and_shift(seed, rows=4):
    """Codes of N(0, I) and a shift of norm 0.2 a row, the cell's eps."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(rows, CFG["dim_z"], generator=g)
    s = torch.randn(rows, CFG["dim_z"], generator=g)
    return z, 0.2 * s / torch.linalg.vector_norm(s, dim=1, keepdim=True)


def rel_rms(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_program_matches_the_reference(seed):
    """In float32 the two differ by rounding alone: the spectral norm folded
    in numpy against torch, and the convolutions' sums in another order,
    about 3e-6 of images in [-1, 1] through 8 convolutions and the
    attention. 3e-5 is ten times that and four orders below what the
    attention block (gamma set to 0) or the shift changes."""
    sd = weights(seed)
    G = family.build_program(CFG, sd, CPU)
    ref = family.build_reference(CFG, sd, quant.exact)
    z, shift = codes_and_shift(seed)
    with torch.no_grad():
        got, want = G(z, shift), ref.render(ref.latent(z), shift)
        gamma = next(k for k in sd if k.endswith(".gamma"))
        without_attention = family.build_reference(
            CFG, dict(sd, **{gamma: torch.zeros(())}), quant.exact).render(z, shift)
        unshifted = ref.render(z, torch.zeros_like(shift))
    assert float(sd[gamma]) != 0.0
    assert got.shape == want.shape == (4, 3, 32, 32)
    assert float((got - want).abs().max()) <= 3e-5
    assert float((without_attention - want).abs().max()) > 0.1
    assert float((unshifted - want).abs().max()) > 0.01


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_program_against_the_bf16_stated_reference(seed):
    """The program rendering in bf16 as the stream does (a bf16 copy of the
    weights, codes and shifts cast to bf16 before they are added) against
    the float32 reference: within 2.5 times the gap of the reference computed
    at the stated precision (each product's operands rounded to bf16), which
    reads 1.3-1.7 % of the image's RMS; the program reads 1.5-1.6 times that
    (every elementwise pass rounds too)."""
    sd = weights(seed)
    G16 = cast_params_bf16(family.build_program(CFG, sd, CPU))
    z, shift = codes_and_shift(seed)
    with torch.no_grad():
        got = G16(z.to(torch.bfloat16), shift.to(torch.bfloat16)).float()
        want = family.build_reference(CFG, sd, quant.exact).render(z, shift)
        stated = family.build_reference(CFG, sd, quant.bf16).render(z, shift)
    stated_gap = rel_rms(stated, want)
    assert 1e-3 < stated_gap < 0.03
    assert rel_rms(got, want) <= 2.5 * stated_gap


def host_spans(prof, prefix=("wgs.", "test.")) -> list:
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith(prefix))


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_of_a_forward_and_of_the_render_stream():
    """One ``wgs.biggan.attention`` a forward and two ``wgs.biggan.ccbn`` a
    block, each inside ``wgs.render.generator``; a consumer that sleeps
    between two ``next()`` calls is inside no span."""
    G = family.build_program(CFG, weights(1), CPU)
    z, shift = codes_and_shift(1, rows=6)
    n_blocks = len(family.blocks(CFG))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = 0
        for _ in iter_rendered_u8(G, z, shift, 4):
            batches += 1
            with record_function("test.consumer_sleep"):
                time.sleep(0.05)
    spans = host_spans(prof)
    generator = [s for s in spans if s[2] == "wgs.render.generator"]
    attention = [s for s in spans if s[2] == "wgs.biggan.attention"]
    ccbn = [s for s in spans if s[2] == "wgs.biggan.ccbn"]
    assert batches == len(generator) == 2
    assert len(attention) == batches and len(ccbn) == 2 * n_blocks * batches
    for s in attention + ccbn:
        assert any(inside(s, g) for g in generator), s
    for sleep in (s for s in spans if s[2] == "test.consumer_sleep"):
        assert not [s for s in spans if s[2].startswith("wgs.") and inside(sleep, s)]
