"""The measured window as ``torch.profiler`` traced it: device intervals
(kernels apart from copies and memsets), the host spans of the benchmark
(``bench.*``) and of the port (``wgs.*``, ``warpedganspace_torch/utils/spans.py``),
the port's spans open at each kernel's and copy's launch, and what the
per-layer metrics and the breakdown read from them. Times are nanoseconds on
the tracer's clock.

A kernel or copy belongs to the port's spans that were open, on the thread
that launched it, when it was launched: its device event shares a
correlation id with a CUDA API call on the host (``cudaLaunchKernel*``,
``cuLaunchKernel``, ``cudaMemcpyAsync``, ...), whose start and thread are
matched to the spans. Nothing is put down by device time: a kernel runs after
its span has closed, while the host issues the next batch."""
from __future__ import annotations

import collections
import dataclasses
import re

_COPY_PREFIXES = ("Memcpy", "Memset")
WINDOW = "bench.window"
BENCH = "bench."
PROGRAM = "wgs."
BETWEEN = "bench.window (between spans)"
# Host calls of the CUDA API (``cuda*``, ``cu*``) that a device event can correlate with.
LAUNCH = re.compile(r"^cu(da)?[A-Z]")

# One profiler event, as plain values: its name, start and end (ns on the
# tracer's clock), whether the device ran it, the host thread that recorded it
# and its correlation id.
Event = collections.namedtuple("Event", "name start end on_device thread corr")


@dataclasses.dataclass
class Trace:
    window: tuple            # (start, end) of the bench.window span
    kernels: list            # (start, end, name)
    copies: list             # (start, end, name)
    spans: list              # (start, end, name) of the bench.* host spans
    program_spans: list = dataclasses.field(default_factory=list)
    #                          (start, end, name) of the wgs.* host spans
    launched: list = dataclasses.field(default_factory=list)
    #                          (start, end, name, spans) of every kernel and copy; spans:
    #                          the wgs.* spans open at its launch on its thread, outermost first

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self, events):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), n) for s, e, n in events if e > lo and s < hi]

    def busy_s(self) -> float:
        """The union of kernel and copy intervals inside the window."""
        return union_ns(self.clipped(self.kernels + self.copies)) / 1e9

    def kernel_s(self, match=None) -> float:
        """Kernel time summed inside the window (of the kernels ``match`` takes)."""
        return sum(e - s for s, e, n in self.clipped(self.kernels)
                   if match is None or match(n)) / 1e9

    def copy_s(self) -> float:
        """Copy and memset time summed inside the window."""
        return sum(e - s for s, e, _ in self.clipped(self.copies)) / 1e9

    def launched_s(self, names=None, copies=True) -> float:
        """Kernel time in the window (with copy time, ``copies``) launched
        inside one of the wgs.* spans ``names`` (nested spans included), or
        inside any wgs.* span when ``names`` is None."""
        lo, hi = self.window
        total = 0
        for s, e, n, spans in self.launched:
            if e <= lo or s >= hi or not spans or (not copies and n.startswith(_COPY_PREFIXES)):
                continue
            if names is None or any(x in names for x in spans):
                total += min(e, hi) - max(s, lo)
        return total / 1e9

    def span_s(self, name: str) -> tuple:
        """(seconds, count) of the wgs.* host spans ``name`` in the window."""
        spans = self.clipped([p for p in self.program_spans if p[2] == name])
        return sum(e - s for s, e, _ in spans) / 1e9, len(spans)


def events(prof):
    """A finished profile's raw events as :class:`Event` tuples. Reads the
    raw events, not ``events()``, whose Python event tree is slow to build
    for 10^5 launches."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield Event(e.name(), e.start_ns(), e.end_ns(), e.device_type() == cuda,
                    e.device_resource_id(), e.correlation_id())


def collect(prof) -> Trace:
    """A finished profile's window."""
    return from_events(events(prof))


def from_events(events) -> Trace:
    """The window of plain :class:`Event` tuples (one ``bench.window`` span
    among them). Device ranges named after a span of either family (the
    profiler mirrors a user annotation that holds kernels among the device
    events) are no device work and are dropped."""
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
    return Trace(window=window,
                 kernels=[d[:3] for d in launched if not d[2].startswith(_COPY_PREFIXES)],
                 copies=[d[:3] for d in launched if d[2].startswith(_COPY_PREFIXES)],
                 spans=[b for b in bench if b[2] != WINDOW],
                 program_spans=[p[:3] for p in program], launched=launched)


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


def union_ns(intervals) -> float:
    busy, edge = 0.0, None
    for s, e, _ in sorted(intervals):
        if edge is None or s > edge:
            busy += e - s
            edge = e
        elif e > edge:
            busy += e - edge
            edge = e
    return busy


def idle_gaps(trace: Trace) -> list:
    """(start, end) of every stretch of the window in which the device ran nothing."""
    gaps, edge = [], trace.window[0]
    for s, e, _ in sorted(trace.clipped(trace.kernels + trace.copies)):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if trace.window[1] > edge:
        gaps.append((edge, trace.window[1]))
    return gaps


def host_activity(trace: Trace, times) -> list:
    """For each host time of ``times``, the innermost span of either family
    (``bench.*`` or ``wgs.*``) open around it, or the harness's own loop when
    none is."""
    spans = [(s, e, n, 0) for s, e, n in trace.spans + trace.program_spans]
    stacks = open_spans(spans, [(t, 0) for t in times])
    return [st[-1] if st else BETWEEN for st in stacks]


def short_name(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace, rows: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing, in seconds."""
    by_name = {}
    for s, e, n in trace.clipped(trace.kernels + trace.copies):
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:rows]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:rows]
    names = host_activity(trace, [(s + e) / 2 for s, e in gaps])
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, (e - s) / 1e9] for n, (s, e) in zip(names, gaps)]}


def roofline_share(view, patterns, sections, least_ms) -> float | None:
    """A kernel's share of its roofline over the traced window: each launch's
    least time at its shape, summed, over the kernel's profiled time.
    ``patterns`` find a launch's channel count C in a kernel's name,
    ``sections`` maps C to the launch's shape, ``least_ms(shape)`` gives the
    least time. None where no launch is found."""

    bound_ms = kernel_ms = 0.0
    for t in view.traces:
        for s, e, name in t.clipped(t.kernels):
            m = next((m for m in (re.search(p, name) for p in patterns) if m), None)
            if m is None or int(m.group(1)) not in sections:
                continue
            bound_ms += least_ms(sections[int(m.group(1))])
            kernel_ms += (e - s) / 1e6
    return 100.0 * bound_ms / kernel_ms if kernel_ms else None
