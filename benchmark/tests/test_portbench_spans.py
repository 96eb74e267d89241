"""The port's spans in a trace (``benchmark/trace.py``, ``benchmark/spans.py``):
on synthetic events, a span's device mirror is no device work and the
window reads what it read when only the benchmark's spans were kept, a
launch goes to the innermost span open on its thread, idle gaps are named by
the innermost span of either family, and the quantities and their readers
read what they say; on the card (``-m gpu``), the render cells' kernel and
copy time is all put down to the port's spans."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spans as sp
from benchmark import trace as tr
from benchmark.tests.portbench_tiny import render_cells
from benchmark.trace import Event

SPAN_METRICS = ("generator_ms_per_frame.render", "stream_ms_per_frame.render",
                "host_issue_ms_per_batch.render", "tail_weights_ms_per_frame.render")
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
    with_spans, without = tr.from_events(events()), tr.from_events(events(program=False))
    for t in (with_spans, without):
        assert [k[2] for k in t.kernels] == ["gemm", "weights_kernel", "to_u8_kernel",
                                             "outside_kernel"]
        assert t.kernel_s() == pytest.approx(130e-9)
        assert t.busy_s() == pytest.approx(190e-9)
        assert t.copy_s() == pytest.approx(60e-9)
    assert with_spans.kernel_s() == without.kernel_s()
    assert with_spans.busy_s() == without.busy_s()


def test_a_launch_goes_to_the_spans_open_on_its_thread():
    launched = {n: spans for _, _, n, spans in tr.from_events(events()).launched}
    assert launched["gemm"] == ("wgs.render.issue", "wgs.render.generator")
    assert launched["weights_kernel"] == ("wgs.render.issue", "wgs.render.generator",
                                          "wgs.sg2_tail.weights")
    assert launched["to_u8_kernel"] == ("wgs.render.issue", "wgs.render.to_u8")
    assert launched["Memcpy DtoH (Device -> Pinned)"] == ("wgs.render.issue", "wgs.render.d2h")
    # Launched on thread 7 while only thread 8 had a span open: it belongs to
    # none, though it runs while that span is open.
    assert launched["outside_kernel"] == ()


def test_a_gap_is_named_by_the_innermost_span_of_either_family():
    t = tr.from_events(events())
    assert tr.host_activity(t, [55, 350, 15, 500]) == [
        "wgs.sg2_tail.weights", "wgs.render.wait", "bench.render_batch",
        "bench.window (between spans)"]
    rep = sp.report(t, 4, rows=2)
    assert rep["idle_gaps"] == [["bench.window (between spans)", pytest.approx(570e-9)],
                                ["wgs.render.to_u8", pytest.approx(140e-9)]]
    assert dict(rep["idle_s_by_span"]) == pytest.approx({
        "bench.window (between spans)": 570e-9, "wgs.render.to_u8": 140e-9,
        "wgs.sg2_tail.weights": 100e-9})


def test_the_quantities_read_what_they_say():
    assert set(sp.quantities(tr.from_events(events(program=False)), 4).values()) == {None}
    q = sp.quantities(tr.from_events(events()), 4)
    assert q["generator_ms_per_frame"] == pytest.approx(60e-6 / 4)       # gemm + weights
    assert q["stream_ms_per_frame"] == pytest.approx(80e-6 / 4)          # to_u8 + copy
    assert q["tail_weights_ms_per_frame"] == pytest.approx(10e-6 / 4)
    assert q["traverse_ms_per_frame"] is None                            # no wgs.traverse
    # (issue 280 + deliver 70 - wait 60) over the two issue spans of the window.
    assert q["host_issue_ms_per_batch"] == pytest.approx((280 + 90 + 70 - 60) * 1e-6 / 2)
    assert q["attributed_pct"] == pytest.approx(100.0 * 140 / 190)


def _profile(evs):
    """A finished profile holding ``evs``, as ``benchmark.trace.events`` reads one."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Raw:
        def __init__(self, e):
            self.e = e

        def name(self):
            return self.e.name

        def start_ns(self):
            return self.e.start

        def end_ns(self):
            return self.e.end

        def device_type(self):
            return cuda if self.e.on_device else cpu

        def device_resource_id(self):
            return self.e.thread

        def correlation_id(self):
            return self.e.corr

    results = SimpleNamespace(events=lambda: [Raw(e) for e in evs])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _bench_spans_only(evs) -> tr.Trace:
    """The window as the harness read it when it kept the bench.* spans
    alone: every device event but those named after a bench.* host span."""
    spans = [(e.start, e.end, e.name) for e in evs
             if not e.on_device and e.name.startswith("bench.")]
    host = {n for _, _, n in spans}
    device = [(e.start, e.end, e.name) for e in evs if e.on_device and e.name not in host]
    copy = ("Memcpy", "Memset")
    return tr.Trace(window=next((s, e) for s, e, n in spans if n == tr.WINDOW),
                    kernels=[d for d in device if not d[2].startswith(copy)],
                    copies=[d for d in device if d[2].startswith(copy)],
                    spans=[x for x in spans if x[2] != tr.WINDOW])


def test_collect_reads_the_window_as_the_bench_spans_alone_read_it():
    """``collect`` on a profile with the port's spans and a device mirror of
    one: the kernels, copies, kernel time and busy time, to the last digit,
    that keeping the bench.* spans alone read on the same profile as the
    card records it (no wgs.* mirror), and on a program without spans."""
    got = tr.collect(_profile(events()))
    as_recorded = [e for e in events() if not (e.on_device and e.name.startswith("wgs."))]
    for want in (_bench_spans_only(as_recorded), _bench_spans_only(events(program=False))):
        assert got.kernels == want.kernels and got.copies == want.copies
        assert got.kernel_s() == want.kernel_s() and got.busy_s() == want.busy_s()
    assert got.program_spans and got.launched
    # Kept alone, the bench.* spans let the port's mirror in as a kernel.
    assert _bench_spans_only(events()).kernel_s() > got.kernel_s()


def test_the_breakdown_names_a_gap_by_the_port_spans():
    gaps = tr.breakdown(tr.from_events(events()), rows=2)["idle_gaps"]
    assert [n for n, _ in gaps] == ["bench.window (between spans)", "wgs.render.to_u8"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_metric_reads_its_quantity(name):
    """Each reader gives its quantity of one trace, the mean over two cards'
    traces (each with its share of the frames), and None without wgs.*
    spans or frames."""
    quantity = name.split(".")[0]
    one = tr.from_events(events())
    read = bench_run.reader(name).read

    def view(traces, frames):
        return bench_run.View(traces=traces, work={"frames": frames}, config={}, params={})
    assert read(view([one], 4)) == sp.quantities(one, 4)[quantity]
    assert read(view([one, one], 8)) == pytest.approx(sp.quantities(one, 4)[quantity])
    assert read(view([tr.from_events(events(program=False))], 4)) is None
    assert read(view([one], 0)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", render_cells())
def test_the_render_cells_device_time_is_put_down_to_the_port_spans(cell, card):
    """A 2 s traced window: 99 % of the kernel and copy time launched inside
    some wgs.* span; the generator's and the stream's time within the
    window's kernels and copies; the window's kernel and busy time as the
    bench.* spans alone read them; each span metric read, above 0."""
    run = bench_run.make_run(cell, 2 ** 33 + 303, 2.0, True, card)
    raw, out = sp.trace_window(run)
    t = tr.from_events(raw)
    frames = out["work"]["frames"]
    q = sp.quantities(t, frames)
    assert q["attributed_pct"] >= 99.0, sp.report(t, frames)
    device_ms_per_frame = 1e3 * t.kernel_s() / frames
    copy_ms_per_frame = 1e3 * t.copy_s() / frames
    assert (q["generator_ms_per_frame"] + q["stream_ms_per_frame"]
            <= device_ms_per_frame + copy_ms_per_frame)
    alone = _bench_spans_only(raw)
    assert alone.kernel_s() == t.kernel_s() and alone.busy_s() == t.busy_s()
    view = bench_run.View(traces=[t], work=out["work"], config=run.config, params=run.params)
    for name in SPAN_METRICS:
        assert bench_run.reader(name).read(view) > 0, name
