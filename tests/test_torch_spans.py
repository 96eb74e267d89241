"""The port's spans (``warpedganspace_torch/utils/spans.py``) under
``torch.profiler`` on the CPU: each appears where the render stream, the
traversal and the tail wrappers do their work, nests under its parent, is
never open across the stream's ``yield``, and changes no output."""
import contextlib
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from warpedganspace_torch.models.support_sets import SupportSets
from warpedganspace_torch.ops import proggan_tail_cuda, sg2_tail_cuda
from warpedganspace_torch.traverse.engine import iter_rendered_u8, traverse_paths

torch.set_num_threads(1)

RENDER_CHILDREN = {"wgs.render.generator": "wgs.render.issue",
                   "wgs.render.to_u8": "wgs.render.issue",
                   "wgs.render.pin_alloc": "wgs.render.issue",
                   "wgs.render.d2h": "wgs.render.issue",
                   "wgs.render.wait": "wgs.render.deliver"}
TRAVERSE_CHILDREN = {"wgs.traverse.prepare_sets": "wgs.traverse",
                     "wgs.traverse.integrate": "wgs.traverse",
                     "wgs.traverse.assemble": "wgs.traverse"}


@pytest.fixture(scope="module", autouse=True)
def profiler_started_once():
    """The profiler's first start in a process takes seconds; pay it here."""
    with profile(activities=[ProfilerActivity.CPU]):
        pass


def host_spans(prof, prefix=("wgs.", "test.")) -> list:
    """(start, end, name) of the host events whose names start with ``prefix``."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith(prefix))


def named(spans, name) -> list:
    return [s for s in spans if s[2] == name]


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def tiny_generator(codes, shifts, latent_is_w=False):
    """(B, d) rows -> (B, 3, 2, 2) images, deterministic."""
    return torch.tanh(codes + 2 * shifts)[:, :12].reshape(-1, 3, 2, 2)


def tiny_paths(seed=0):
    g = torch.Generator().manual_seed(seed)
    S = SupportSets(3, 4, 12, learn_gammas=True, generator=g)
    z = torch.randn(2, 12, generator=g)
    return S, z


def run_all(consumer_sleep=0.0):
    """Traverse the tiny paths, then stream all of one code's frames in
    batches of 4 (the last padded), sleeping between ``next()`` calls."""
    S, z = tiny_paths()
    codes, shifts = traverse_paths(S, z, eps=0.2, shift_steps=2)
    flat_c, flat_s = codes[0].reshape(-1, 12), shifts[0].reshape(-1, 12)
    frames = []
    for start, img in iter_rendered_u8(tiny_generator, flat_c, flat_s, 4):
        frames.append((start, img.copy()))
        if consumer_sleep:
            with record_function("test.consumer_sleep"):
                time.sleep(consumer_sleep)
    return codes, shifts, frames


def test_every_span_appears_and_nests_under_its_parent():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, frames = run_all()
    spans = host_spans(prof)
    assert [f[0] for f in frames] == [0, 4, 8, 12] and frames[-1][1].shape[0] == 3
    for name in ("wgs.render.issue", "wgs.render.deliver", *RENDER_CHILDREN):
        assert len(named(spans, name)) == len(frames), name
    for child, parent in RENDER_CHILDREN.items():
        for c in named(spans, child):
            assert any(inside(c, p) for p in named(spans, parent)), (child, parent)
    for issue in named(spans, "wgs.render.issue"):
        assert not any(inside(d, issue) for d in named(spans, "wgs.render.deliver"))
    (traverse,) = named(spans, "wgs.traverse")
    for child in TRAVERSE_CHILDREN:
        (c,) = named(spans, child)
        assert inside(c, traverse), child
    order = [named(spans, n)[0][0] for n in TRAVERSE_CHILDREN]
    assert order == sorted(order)


def test_no_render_span_is_open_across_a_yield():
    """A consumer that sleeps 50 ms between two ``next()`` calls: no render
    span holds the sleep (the stream's spans time the stream alone)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_all(consumer_sleep=0.05)
    spans = host_spans(prof)
    sleeps = named(spans, "test.consumer_sleep")
    render = [s for s in spans if s[2].startswith("wgs.render.")]
    assert len(sleeps) == 4 and render
    for sleep in sleeps:
        assert not [r for r in render if inside(sleep, r)]
    assert max(e - s for s, e, _ in render) < 0.05e9


def test_outputs_are_bit_identical_with_the_profiler_on_and_off():
    codes, shifts, frames = run_all()
    with profile(activities=[ProfilerActivity.CPU]):
        codes_p, shifts_p, frames_p = run_all()
    assert torch.equal(codes, codes_p) and torch.equal(shifts, shifts_p)
    assert [f[0] for f in frames] == [f[0] for f in frames_p]
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(frames, frames_p))


def _sg2_operands(c=16, b=2, h=4, w=4):
    g = torch.Generator().manual_seed(1)
    r = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16)  # noqa: E731
    return (r(b, 2 * c, h, w), r(c, 2 * c, 3, 3), r(c, c, 3, 3), r(3, c, 1, 1),
            r(b, 2 * c), r(b, c), r(b, c), r(b, c), r(b, c), r(1, 1, 2 * h, 2 * w), r(1),
            r(c), r(1, 1, 2 * h, 2 * w), r(1), r(c), r(3))


def _proggan_operands(c=16, b=2, h=4, w=4):
    g = torch.Generator().manual_seed(2)
    r = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16)  # noqa: E731
    return (r(b, 2 * c, h, w), r(c, 2 * c, 3, 3), r(c), r(1), r(c, c, 3, 3), r(c), r(1),
            (r(3, c, 1, 1), r(3), r(1)))


@pytest.mark.parametrize("module, entry, call", [
    (sg2_tail_cuda, "sg2_tail_section_launch",
     lambda: sg2_tail_cuda._launch(True, *_sg2_operands())),
    (proggan_tail_cuda, "proggan_tail_section_launch",
     lambda: proggan_tail_cuda._launch(*_proggan_operands())),
], ids=["sg2_tail", "proggan_tail"])
def test_a_tail_launch_prepares_its_weights_in_its_span(module, entry, call, monkeypatch):
    """The wrapper's weight preparation, and not the launch, inside
    ``wgs.<tail>.weights``: the C launch replaced by a stub that records
    itself, on CPU operands (the card's launch path otherwise)."""
    def launch(*args):
        with record_function("test.launch"):
            return 0
    monkeypatch.setattr(module, "build", lambda: types.SimpleNamespace(**{entry: launch}))
    monkeypatch.setattr(module, "launches", module.launches)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = host_spans(prof)
    name = "wgs." + module.SOURCE.split(".")[0] + ".weights"
    (weights,) = named(spans, name)
    (launched,) = named(spans, "test.launch")
    assert weights[1] <= launched[0]
    ops = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::to"]
    assert any(inside(op + ("",), weights) for op in ops)
