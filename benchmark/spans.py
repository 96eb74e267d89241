"""The port's own spans in a traced render window.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

sets a render cell up as ``benchmark.run`` does, traces one window of it with
``torch.profiler`` (host and device) and prints one JSON line: the device's
kernel and copy time put down to the port's spans (``wgs.*``,
``warpedganspace_torch/utils/spans.py``), the device's idle gaps named by the
innermost span of either family (``bench.*`` or ``wgs.*``) open at their
middle, and the window's numbers as ``benchmark.trace`` reads them, which the
port's spans must leave as they are.

A kernel or copy belongs to the spans that were open, on the thread that
launched it, when it was launched: its device event shares a correlation id
with a CUDA API call on the host (``cudaLaunchKernel*``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...), whose start and thread are matched to the spans.
Nothing is put down by device time: a kernel runs after its span has closed,
while the host issues the next batch.

The quantities (per frame delivered, or per render batch):

- ``generator_ms_per_frame``: kernel time launched inside
  ``wgs.render.generator`` (the tails' weight preparation nested in it
  included);
- ``stream_ms_per_frame``: kernel and copy time launched inside
  ``wgs.render.to_u8`` and ``wgs.render.d2h`` (the uint8 conversion and the
  device-to-host copy);
- ``tail_weights_ms_per_frame``: kernel time launched inside
  ``wgs.sg2_tail.weights`` or ``wgs.proggan_tail.weights``;
- ``traverse_ms_per_frame``: kernel and copy time launched inside
  ``wgs.traverse``;
- ``host_issue_ms_per_batch``: host time in ``wgs.render.issue`` and
  ``wgs.render.deliver`` less ``wgs.render.wait``, per issue span;
- ``attributed_pct``: the share of all kernel and copy time in the window
  that some ``wgs.*`` span launched.

Each is None where the trace holds no ``wgs.*`` span (a program without
them).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re
import sys

from benchmark.trace import _COPY_PREFIXES, WINDOW, Trace, collect, idle_gaps

PROGRAM = "wgs."
BENCH = "bench."
# Host calls of the CUDA API (``cuda*``, ``cu*``) that a device event can correlate with.
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
GENERATOR = ("wgs.render.generator",)
STREAM = ("wgs.render.to_u8", "wgs.render.d2h")
TAIL_WEIGHTS = ("wgs.sg2_tail.weights", "wgs.proggan_tail.weights")
TRAVERSE = ("wgs.traverse",)
ISSUE, DELIVER, WAIT = "wgs.render.issue", "wgs.render.deliver", "wgs.render.wait"

# One profiler event, as plain values: its name, start and end (ns on the
# tracer's clock), whether the device ran it, the host thread that recorded it
# and its correlation id.
Event = collections.namedtuple("Event", "name start end on_device thread corr")


def events(prof):
    """A finished profile's raw events as :class:`Event` tuples."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield Event(e.name(), e.start_ns(), e.end_ns(), e.device_type() == cuda,
                    e.device_resource_id(), e.correlation_id())


@dataclasses.dataclass
class ProgramTrace:
    base: Trace          # the window as benchmark.trace keeps it
    program_spans: list  # (start, end, name) of the wgs.* host spans
    launched: list       # (start, end, name, spans) of every kernel and copy; spans:
    #                      the wgs.* spans open at its launch on its thread, outermost first

    def launched_s(self, names=None, copies=True) -> float:
        """Kernel time in the window (with copy time, ``copies``) launched
        inside one of the spans ``names`` (nested spans included), or inside
        any wgs.* span when ``names`` is None."""
        lo, hi = self.base.window
        total = 0
        for s, e, n, spans in self.launched:
            if e <= lo or s >= hi or not spans or (not copies and n.startswith(_COPY_PREFIXES)):
                continue
            if names is None or any(x in names for x in spans):
                total += min(e, hi) - max(s, lo)
        return total / 1e9

    def span_s(self, name: str) -> tuple:
        """(seconds, count) of the host spans ``name`` in the window."""
        spans = self.base.clipped([p for p in self.program_spans if p[2] == name])
        return sum(e - s for s, e, _ in spans) / 1e9, len(spans)


def from_events(events) -> ProgramTrace:
    """The window of plain :class:`Event` tuples (one ``bench.window`` span
    among them). Device ranges named after a span (the profiler mirrors a
    user annotation that holds kernels among the device events) are no device
    work and are dropped."""
    bench, program, device, launches = [], [], [], {}
    for name, start, end, on_device, thread, corr in events:
        if on_device:
            if not name.startswith((BENCH, PROGRAM)):
                device.append((start, end, name, corr))
        elif name.startswith(BENCH):
            bench.append((start, end, name))
        elif name.startswith(PROGRAM):
            program.append((start, end, name, thread))
        elif LAUNCH.match(name):
            launches[corr] = (start, thread)
    window = next((s, e) for s, e, n in bench if n == WINDOW)
    stacks = open_spans(program, [launches.get(d[3]) for d in device])
    launched = [(s, e, n, st) for (s, e, n, _), st in zip(device, stacks)]
    base = Trace(window=window,
                 kernels=[d[:3] for d in launched if not d[2].startswith(_COPY_PREFIXES)],
                 copies=[d[:3] for d in launched if d[2].startswith(_COPY_PREFIXES)],
                 spans=[b for b in bench if b[2] != WINDOW])
    return ProgramTrace(base, [p[:3] for p in program], launched)


def open_spans(spans, launches) -> list:
    """For each launch ``(start, thread)`` (or None), the names of the
    ``(start, end, name, thread)`` spans open on its thread at its start,
    outermost first. Spans of one thread nest; a launch at a span's edge is
    inside it."""
    marks = [(s, 0, i) for i, (s, _, _, _) in enumerate(spans)]
    marks += [(e, 2, i) for i, (_, e, _, _) in enumerate(spans)]
    marks += [(x[0], 1, j) for j, x in enumerate(launches) if x is not None]
    marks.sort()
    open_on, out = collections.defaultdict(list), [()] * len(launches)
    for _, kind, i in marks:
        if kind == 0:
            open_on[spans[i][3]].append(i)
        elif kind == 2:
            open_on[spans[i][3]].remove(i)
        else:
            out[i] = tuple(spans[k][2] for k in open_on[launches[i][1]])
    return out


def host_activity(pt: ProgramTrace, times) -> list:
    """For each host time of ``times``, the innermost span of either family
    open around it, or the harness's own loop when none is."""
    spans = [(s, e, n, 0) for s, e, n in pt.base.spans + pt.program_spans]
    stacks = open_spans(spans, [(t, 0) for t in times])
    return [st[-1] if st else "bench.window (between spans)" for st in stacks]


def copy_s(trace: Trace) -> float:
    """Copy and memset time summed inside the window."""
    return sum(e - s for s, e, _ in trace.clipped(trace.copies)) / 1e9


def quantities(pt: ProgramTrace, frames: int) -> dict:
    """The quantities of the module's docstring; None without wgs.* spans or frames."""
    names = ("generator_ms_per_frame", "stream_ms_per_frame", "tail_weights_ms_per_frame",
             "traverse_ms_per_frame", "host_issue_ms_per_batch", "attributed_pct")
    if not pt.program_spans or not frames:
        return dict.fromkeys(names)
    per_frame = {"generator_ms_per_frame": pt.launched_s(GENERATOR, copies=False),
                 "stream_ms_per_frame": pt.launched_s(STREAM),
                 "tail_weights_ms_per_frame": pt.launched_s(TAIL_WEIGHTS, copies=False),
                 "traverse_ms_per_frame": pt.launched_s(TRAVERSE)}
    out = {k: 1e3 * v / frames for k, v in per_frame.items()}
    (issue_s, batches), (deliver_s, _), (wait_s, _) = map(pt.span_s, (ISSUE, DELIVER, WAIT))
    out["host_issue_ms_per_batch"] = (1e3 * (issue_s + deliver_s - wait_s) / batches
                                      if batches else None)
    device_s = pt.base.kernel_s() + copy_s(pt.base)
    out["attributed_pct"] = 100.0 * pt.launched_s() / device_s if device_s else None
    return out


def report(pt: ProgramTrace, frames: int, rows: int = 10) -> dict:
    """The quantities, the device time by the innermost span that launched
    it, the host time in each span, the idle time by the span
    :func:`host_activity` names at each idle gap's middle, and the longest
    gaps so named, in seconds."""
    by_span, idle = collections.Counter(), collections.Counter()
    lo, hi = pt.base.window
    for s, e, n, spans in pt.launched:
        if e > lo and s < hi:
            by_span[spans[-1] if spans else "(no wgs span)"] += (min(e, hi) - max(s, lo)) / 1e9
    host = {n: pt.span_s(n) for n in sorted({p[2] for p in pt.program_spans})}
    gaps = idle_gaps(pt.base)
    named = list(zip(host_activity(pt, [(s + e) / 2 for s, e in gaps]), gaps))
    for n, (s, e) in named:
        idle[n] += (e - s) / 1e9
    longest = sorted(named, key=lambda g: g[1][0] - g[1][1])[:rows]
    return dict(quantities(pt, frames),
                device_s_by_span=by_span.most_common(),
                host_s_by_span={n: {"s": v, "count": c} for n, (v, c) in host.items()},
                idle_s_by_span=idle.most_common(),
                idle_gaps=[[n, (e - s) / 1e9] for n, (s, e) in longest])


def trace_window(run) -> tuple:
    """Set ``run`` up and trace one window of it as ``benchmark.run`` does:
    its :class:`ProgramTrace`, ``benchmark.trace``'s view of the same profile,
    and the traffic's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    state = run.traffic.setup(run)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with record_function(WINDOW):
        out = run.traffic.window(run, state)
    prof.stop()
    torch.cuda.synchronize()
    return from_events(events(prof)), collect(prof), out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark import run as bench_run

    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 2
    run = bench_run.make_run(args.workload, args.seed, args.seconds, True,
                             torch.device("cuda", 0))
    pt, harness, out = trace_window(run)
    frames = out["work"]["frames"]
    result = {"workload": args.workload, "seed": args.seed, "frames": frames,
              "render_frames_per_s": out["values"]["render_frames_per_s"],
              "window_s": pt.base.window_s, "busy_s": pt.base.busy_s(),
              "kernel_s": pt.base.kernel_s(), "copy_s": copy_s(pt.base),
              "harness": {"busy_s": harness.busy_s(), "kernel_s": harness.kernel_s(),
                          "device_events": len(harness.kernels) + len(harness.copies)},
              "device_events": len(pt.base.kernels) + len(pt.base.copies),
              "device": torch.cuda.get_device_name(0)}
    result.update(report(pt, frames))
    print(json.dumps(result), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
