"""Readings that set a cell's limits: the program's and its control's.

    python3 -m benchmark.calibrate --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at the cell's own load, the numbers the run compares (the
program's reading) and the same numbers for the control, the plain reference
one precision below the configuration's put in the program's place
(``control`` of the cell's traffic), and for each fault the traffic plants
in the reference put in the program's place (its ``FAULTS``). One JSON line a seed on standard output.
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import os.path as osp
import sys

from benchmark.run import CACHE_ENV, ROOT, make_run


def readings(workload: str, seed: int, seconds: float, device) -> dict:
    import torch

    run = make_run(workload, seed, seconds, False, device)
    state = run.traffic.setup(run)
    run.traffic.window(run, state)
    out = run.traffic.outputs(run, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out_readings = {"seed": seed, "program": run.traffic.gaps(run, out),
                    "control": run.traffic.control(run, out)}
    for name, fault in getattr(run.traffic, "FAULTS", {}).items():
        out_readings[name] = fault(run, out)
    return out_readings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    for key, rel in CACHE_ENV.items():
        os.environ[key] = osp.join(ROOT, rel)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
