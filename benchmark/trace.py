"""The measured window as ``torch.profiler`` traced it: device intervals
(kernels apart from copies and memsets), the benchmark's own host spans
(``bench.*``), and what the per-layer metrics and the breakdown read from them.
Times are nanoseconds on the tracer's clock."""
from __future__ import annotations

import dataclasses
import re

import torch

_COPY_PREFIXES = ("Memcpy", "Memset")
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window: tuple            # (start, end) of the bench.window span
    kernels: list            # (start, end, name)
    copies: list             # (start, end, name)
    spans: list              # (start, end, name) of the bench.* host spans

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


def collect(prof) -> Trace:
    """A finished profile's window. Reads the raw events, not ``events()``,
    whose Python event tree is slow to build for 10^5 launches."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            device.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("bench."):
            spans.append((e.start_ns(), e.end_ns(), name))
    # Host spans that hold kernels reappear as device ranges of the same name.
    host = {n for _, _, n in spans}
    device = [d for d in device if d[2] not in host]
    window = next((s, e) for s, e, n in spans if n == WINDOW)
    return Trace(window=window,
                 kernels=[d for d in device if not d[2].startswith(_COPY_PREFIXES)],
                 copies=[d for d in device if d[2].startswith(_COPY_PREFIXES)],
                 spans=[s for s in spans if s[2] != WINDOW])


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


def host_activity(trace: Trace, t: float) -> str:
    """The innermost bench.* span around host time ``t``, or the harness's
    own loop when none is."""
    inner = None
    for s, e, n in trace.spans:
        if s <= t <= e and (inner is None or e - s < inner[1] - inner[0]):
            inner = (s, e, n)
    return inner[2] if inner else "bench.window (between spans)"


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
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[host_activity(trace, (s + e) / 2), (e - s) / 1e9] for s, e in gaps]}


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
