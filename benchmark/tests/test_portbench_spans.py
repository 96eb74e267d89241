"""The port's spans in a trace (``benchmark/spans.py``): on synthetic events,
a span's device mirror is no device work, a launch goes to the innermost span
open on its thread, idle gaps are named by the innermost span of either
family, and the quantities read what they say; on the card (``-m gpu``), the
render cells' kernel and copy time is all put down to the port's spans."""
import pytest
import torch

from benchmark import run as bench_run
from benchmark import spans as sp
from benchmark.spans import Event

T = 7  # the host thread


def events(program=True) -> list:
    """A window of 1000 ns: one render batch's issue (generator with a tail's
    weights nested, uint8 conversion, copy) and delivery, and a kernel
    launched outside every port span. ``program=False`` drops every wgs.*
    event, as a program without spans records none."""
    ev = [
        Event("bench.window", 0, 1000, False, T, 1),
        Event("bench.render_batch", 10, 400, False, T, 2),
        Event("wgs.render.issue", 20, 300, False, T, 3),
        Event("wgs.render.generator", 30, 200, False, T, 4),
        Event("wgs.sg2_tail.weights", 50, 80, False, T, 5),
        Event("wgs.render.to_u8", 210, 250, False, T, 6),
        Event("wgs.render.d2h", 260, 290, False, T, 7),
        Event("wgs.render.deliver", 320, 390, False, T, 8),
        Event("wgs.render.wait", 325, 385, False, T, 9),
        Event("wgs.render.issue", 900, 990, False, 8, 10),   # another thread's
        Event("cudaLaunchKernel", 40, 45, False, T, 101),
        Event("cudaLaunchKernelExC", 60, 65, False, T, 102),
        Event("cudaLaunchKernel", 220, 225, False, T, 103),
        Event("cudaMemcpyAsync", 270, 275, False, T, 104),
        Event("cudaLaunchKernel", 920, 925, False, T, 105),
        Event("aten::add", 39, 46, False, T, 101),              # not a launch
        Event("gemm", 100, 150, True, 0, 101),
        Event("weights_kernel", 150, 160, True, 0, 102),
        Event("to_u8_kernel", 300, 320, True, 0, 103),
        Event("Memcpy DtoH (Device -> Pinned)", 320, 380, True, 0, 104),
        Event("outside_kernel", 950, 1000, True, 0, 105),
        Event("wgs.render.issue", 100, 380, True, 0, 3),        # the device mirrors
        Event("bench.window", 100, 1000, True, 0, 1),
    ]
    return [e for e in ev if program or not e.name.startswith("wgs.")]


def test_a_span_mirrored_on_the_device_is_no_device_work():
    with_spans, without = sp.from_events(events()), sp.from_events(events(program=False))
    for pt in (with_spans, without):
        assert [k[2] for k in pt.base.kernels] == ["gemm", "weights_kernel", "to_u8_kernel",
                                                   "outside_kernel"]
        assert pt.base.kernel_s() == pytest.approx(130e-9)
        assert pt.base.busy_s() == pytest.approx(190e-9)
        assert sp.copy_s(pt.base) == pytest.approx(60e-9)
    assert with_spans.base.kernel_s() == without.base.kernel_s()
    assert with_spans.base.busy_s() == without.base.busy_s()


def test_a_launch_goes_to_the_spans_open_on_its_thread():
    launched = {n: spans for _, _, n, spans in sp.from_events(events()).launched}
    assert launched["gemm"] == ("wgs.render.issue", "wgs.render.generator")
    assert launched["weights_kernel"] == ("wgs.render.issue", "wgs.render.generator",
                                          "wgs.sg2_tail.weights")
    assert launched["to_u8_kernel"] == ("wgs.render.issue", "wgs.render.to_u8")
    assert launched["Memcpy DtoH (Device -> Pinned)"] == ("wgs.render.issue", "wgs.render.d2h")
    # Launched on thread 7 while only thread 8 had a span open: it belongs to
    # none, though it runs while that span is open.
    assert launched["outside_kernel"] == ()


def test_a_gap_is_named_by_the_innermost_span_of_either_family():
    pt = sp.from_events(events())
    assert sp.host_activity(pt, [55, 350, 15, 500]) == [
        "wgs.sg2_tail.weights", "wgs.render.wait", "bench.render_batch",
        "bench.window (between spans)"]
    rep = sp.report(pt, 4, rows=2)
    assert rep["idle_gaps"] == [["bench.window (between spans)", pytest.approx(570e-9)],
                                ["wgs.render.to_u8", pytest.approx(140e-9)]]
    assert dict(rep["idle_s_by_span"]) == pytest.approx({
        "bench.window (between spans)": 570e-9, "wgs.render.to_u8": 140e-9,
        "wgs.sg2_tail.weights": 100e-9})


def test_the_quantities_read_what_they_say():
    assert set(sp.quantities(sp.from_events(events(program=False)), 4).values()) == {None}
    q = sp.quantities(sp.from_events(events()), 4)
    assert q["generator_ms_per_frame"] == pytest.approx(60e-6 / 4)       # gemm + weights
    assert q["stream_ms_per_frame"] == pytest.approx(80e-6 / 4)          # to_u8 + copy
    assert q["tail_weights_ms_per_frame"] == pytest.approx(10e-6 / 4)
    assert q["traverse_ms_per_frame"] == 0.0
    # (issue 280 + deliver 70 - wait 60) over the two issue spans of the window.
    assert q["host_issue_ms_per_batch"] == pytest.approx((280 + 90 + 70 - 60) * 1e-6 / 2)
    assert q["attributed_pct"] == pytest.approx(100.0 * 140 / 190)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sg2w1024-render-bf16", "proggan1024-render-bf16"])
def test_the_render_cells_device_time_is_put_down_to_the_port_spans(cell, card):
    """A 2 s traced window: 99 % of the kernel and copy time launched inside
    some wgs.* span; the generator's and the stream's time within the
    window's kernels and copies; benchmark.trace's numbers as before."""
    run = bench_run.make_run(cell, 2 ** 33 + 303, 2.0, True, card)
    pt, harness, out = sp.trace_window(run)
    frames = out["work"]["frames"]
    q = sp.quantities(pt, frames)
    assert q["attributed_pct"] >= 99.0, sp.report(pt, frames)
    device_ms_per_frame = 1e3 * pt.base.kernel_s() / frames
    copy_ms_per_frame = 1e3 * sp.copy_s(pt.base) / frames
    assert (q["generator_ms_per_frame"] + q["stream_ms_per_frame"]
            <= device_ms_per_frame + copy_ms_per_frame)
    assert q["tail_weights_ms_per_frame"] > 0 and q["host_issue_ms_per_batch"] > 0
    assert harness.kernel_s() == pt.base.kernel_s() and harness.busy_s() == pt.base.busy_s()
