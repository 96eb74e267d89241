"""The port's own spans in a traced render window.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

sets a render cell up as ``benchmark.run`` does, traces one window of it with
``torch.profiler`` (host and device) and prints one JSON line: the device's
kernel and copy time put down to the port's spans (``wgs.*``,
``warpedganspace_torch/utils/spans.py``) as ``benchmark.trace`` puts it down,
the host's time in each span, and the device's idle gaps named by the
innermost span of either family (``bench.*`` or ``wgs.*``) open at their
middle.

The quantities (per frame delivered, or per render batch), which the
per-layer metrics of the same names read through :func:`read`:

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
them), and a time per frame also where the window holds none of its spans.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

from benchmark.trace import WINDOW, Trace, events, from_events, host_activity, idle_gaps

GENERATOR = ("wgs.render.generator",)
STREAM = ("wgs.render.to_u8", "wgs.render.d2h")
TAIL_WEIGHTS = ("wgs.sg2_tail.weights", "wgs.proggan_tail.weights")
TRAVERSE = ("wgs.traverse",)
ISSUE, DELIVER, WAIT = "wgs.render.issue", "wgs.render.deliver", "wgs.render.wait"
NAMES = ("generator_ms_per_frame", "stream_ms_per_frame", "tail_weights_ms_per_frame",
         "traverse_ms_per_frame", "host_issue_ms_per_batch", "attributed_pct")


def quantities(trace: Trace, frames: int) -> dict:
    """The quantities of the module's docstring; None without wgs.* spans or
    frames, and a time per frame None where none of its spans is in the
    window (a generator without tail kernels has no tail weights to time)."""
    if not trace.program_spans or not frames:
        return dict.fromkeys(NAMES)
    present = {n for _, _, n in trace.clipped(trace.program_spans)}
    per_frame = {"generator_ms_per_frame": (GENERATOR, False),
                 "stream_ms_per_frame": (STREAM, True),
                 "tail_weights_ms_per_frame": (TAIL_WEIGHTS, False),
                 "traverse_ms_per_frame": (TRAVERSE, True)}
    out = {k: 1e3 * trace.launched_s(names, copies) / frames if present & set(names) else None
           for k, (names, copies) in per_frame.items()}
    (issue_s, batches), (deliver_s, _), (wait_s, _) = map(trace.span_s, (ISSUE, DELIVER, WAIT))
    out["host_issue_ms_per_batch"] = (1e3 * (issue_s + deliver_s - wait_s) / batches
                                      if batches else None)
    device_s = trace.kernel_s() + trace.copy_s()
    out["attributed_pct"] = 100.0 * trace.launched_s() / device_s if device_s else None
    return out


def read(view, name: str):
    """The quantity ``name`` of a traced render run, as the mean over the
    cards used (each card's frames its share of the delivered frames); None
    where a card's trace holds nothing for it."""
    frames = view.work.get("frames")
    if not frames:
        return None
    per_card = frames / len(view.traces)
    values = [quantities(t, per_card)[name] for t in view.traces]
    return None if None in values else sum(values) / len(values)


def report(trace: Trace, frames: int, rows: int = 10) -> dict:
    """The quantities, the device time by the innermost span that launched
    it, the host time in each span, the idle time by the span
    :func:`benchmark.trace.host_activity` names at each idle gap's middle,
    and the longest gaps so named, in seconds."""
    by_span, idle = collections.Counter(), collections.Counter()
    lo, hi = trace.window
    for s, e, n, spans in trace.launched:
        if e > lo and s < hi:
            by_span[spans[-1] if spans else "(no wgs span)"] += (min(e, hi) - max(s, lo)) / 1e9
    host = {n: trace.span_s(n) for n in sorted({p[2] for p in trace.program_spans})}
    gaps = idle_gaps(trace)
    named = list(zip(host_activity(trace, [(s + e) / 2 for s, e in gaps]), gaps))
    for n, (s, e) in named:
        idle[n] += (e - s) / 1e9
    longest = sorted(named, key=lambda g: g[1][0] - g[1][1])[:rows]
    return dict(quantities(trace, frames),
                device_s_by_span=by_span.most_common(),
                host_s_by_span={n: {"s": v, "count": c} for n, (v, c) in host.items()},
                idle_s_by_span=idle.most_common(),
                idle_gaps=[[n, (e - s) / 1e9] for n, (s, e) in longest])


def trace_window(run) -> tuple:
    """Set ``run`` up and trace one window of it as ``benchmark.run`` does:
    the profile's raw events (:func:`benchmark.trace.events`) and the
    traffic's result."""
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
    return list(events(prof)), out


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
    raw, out = trace_window(run)
    trace = from_events(raw)
    frames = out["work"]["frames"]
    result = {"workload": args.workload, "seed": args.seed, "frames": frames,
              "render_frames_per_s": out["values"]["render_frames_per_s"],
              "window_s": trace.window_s, "busy_s": trace.busy_s(),
              "kernel_s": trace.kernel_s(), "copy_s": trace.copy_s(),
              "device_events": len(trace.kernels) + len(trace.copies),
              "device": torch.cuda.get_device_name(0)}
    result.update(report(trace, frames))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
