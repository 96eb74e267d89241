"""One run of one cell of the benchmark of warpedganspace_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is found by name: ``benchmark/workloads/<cell>.json`` names its
configuration (``benchmark/configs/<config>.json``, whose ``family`` names
``benchmark/families/<family>.py``), its traffic (``benchmark/traffic/<kind>.py``
and the traffic's parameters), the cards it needs and the limits of its
output check. ``BENCHMARK.json`` says which metrics the cell reports; each
per-layer metric has a reader, ``benchmark/metrics/<name, '.' as '_'>.py``.

A run builds the inputs and the weights on the card from ``--seed``, builds
the program and warms up the cell's shapes (``setup_s``), measures for
``--seconds`` (traced by ``torch.profiler`` with ``--trace 1``), reads the
peak device memory, frees the program, judges what the measured window
produced against the plain reference (``benchmark/reference``), and prints
one JSON line last on standard output, with the numbers compared beside
their limits also as the last lines on standard error.

It exits non-zero and prints no result where the card is missing or too
few cards are visible, and where JAX or the JAX package is loaded at the end.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

from benchmark import families  # noqa: E402

BENCH_DIR = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(BENCH_DIR)
FOREIGN = ("jax", "jaxlib", "flax", "warpedganspace_tpu")
# Build and kernel caches at fixed paths inside the checkout.
CACHE_ENV = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
             "TORCHINDUCTOR_CACHE_DIR": "build/inductor", "CUDA_CACHE_PATH": "build/cuda_cache"}


def load_json(*parts) -> dict:
    with open(osp.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics of BENCHMARK.json that ``cell``
    reports: those that list it, and those without a list (a per-layer one
    then goes with every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def reader(metric: str):
    return importlib.import_module("benchmark.metrics." + metric.replace(".", "_"))


@dataclasses.dataclass
class Run:
    """One run of one cell: what the traffic module is handed."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    params: dict
    family: object
    traffic: object
    device: object
    chips: int


def make_run(workload: str, seed: int, seconds: float, trace: bool, device,
             config_overrides: dict | None = None, param_overrides: dict | None = None) -> Run:
    cell = load_json(BENCH_DIR, "workloads", workload + ".json")
    config = dict(load_json(BENCH_DIR, "configs", cell["config"] + ".json"),
                  **(config_overrides or {}))
    params = dict(cell["params"], **(param_overrides or {}))
    return Run(workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
               cell=cell, config=config, params=params,
               family=families.module(config["family"]),
               traffic=importlib.import_module("benchmark.traffic." + cell["traffic"]),
               device=device, chips=int(cell["chips"]))


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader reads."""

    traces: list
    work: dict
    config: dict
    params: dict


def measure(run: Run, state) -> dict:
    """The measured window, traced with ``run.trace``: the traffic's result
    (its end-to-end values and its work) and, traced, the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = None
    if run.trace:
        activities = [ProfilerActivity.CPU]
        if run.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    with record_function("bench.window"):
        out = run.traffic.window(run, state)
    if prof is not None:
        prof.stop()
        from benchmark.trace import collect

        out["trace"] = collect(prof)
    del prof
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def run_cell(run: Run) -> dict:
    """Set up, measure, judge. Returns the result object, its ``checks`` last."""
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    e2e, per_layer = cell_metrics(bench, run.workload)
    cuda = run.device.type == "cuda"

    state = run.traffic.setup(run)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    setup_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    out = measure(run, state)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(run.device)) if cuda else 0

    outputs = run.traffic.outputs(run, state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = run.traffic.check(run, outputs)

    values = dict(out["values"], setup_s=setup_s)
    metrics = {}
    if run.trace:
        view = View(traces=[out["trace"]], work=out["work"], config=run.config,
                    params=run.params)
        for m in per_layer:
            v = reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.chips, "memory_peak_bytes": int(peak)}
    # A cell without limits has no check, and proves nothing.
    result = {"correct": bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": out["attempted"], "failed": out.get("failed", 0),
              "metrics": metrics, "device": device}
    if run.trace:
        from benchmark.trace import breakdown

        device["busy_s"] = out["trace"].busy_s()
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = breakdown(out["trace"])
    result["checks"] = checks
    return result


def foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, rel in CACHE_ENV.items():
        os.environ[key] = osp.join(ROOT, rel)
    os.environ["USE_FLAX"] = "0"

    import torch

    cell = load_json(BENCH_DIR, "workloads", args.workload + ".json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    import warpedganspace_torch  # noqa: F401  (the program under test must be there)

    run = make_run(args.workload, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0))
    result = run_cell(run)
    foreign = foreign_modules()
    if foreign:
        print(f"benchmark: the process holds {', '.join(foreign)}: the run is void",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
