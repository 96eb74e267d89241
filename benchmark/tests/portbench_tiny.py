"""Tiny sizes of the benchmark's cells for the CPU tests: the same code paths
with small widths (each family module's ``TINY``), so that a whole run fits
in a few seconds; and the cells the tests run, as ``BENCHMARK.json`` lists
them."""
from __future__ import annotations

import glob
import json
import os.path as osp

import torch

from benchmark import families
from benchmark import run as bench_run

CPU = torch.device("cpu")
BENCH_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
ROOT = osp.dirname(BENCH_DIR)
TINY_PARAMS = {
    "render": {"codes": 2, "shift_steps": 2, "batch": 4, "check_frames": 4},
    "train": {"batch": 4, "log_freq": 2},
}


def bench() -> dict:
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def render_cells() -> list:
    """The render cells of one card in ``BENCHMARK.json``, by name."""
    return [w["name"] for w in bench()["workloads"]
            if w["traffic"] == "render" and w["chips"] == 1]


def config(name: str) -> dict:
    with open(osp.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def family_config(family: str) -> dict:
    """The first configuration, by file name, of the generator family ``family``."""
    for path in sorted(glob.glob(osp.join(BENCH_DIR, "configs", "*.json"))):
        with open(path) as f:
            cfg = json.load(f)
        if cfg["family"] == family:
            return cfg
    raise LookupError(f"no configuration of the family {family!r}")


def make_run(workload: str, seed: int = 2 ** 33 + 17, seconds: float = 0.3, trace: bool = False,
             family: str | None = None, params: dict | None = None):
    """``workload`` at its tiny size on the CPU (``family`` swaps in the first
    configuration of another generator family)."""
    with open(osp.join(BENCH_DIR, "workloads", workload + ".json")) as f:
        cell = json.load(f)
    own = config(cell["config"])["family"]
    overrides = family_config(family) if family not in (None, own) else {}
    tiny = families.module(overrides.get("family", own)).TINY
    return bench_run.make_run(workload, seed, seconds, trace, CPU,
                              config_overrides=dict(overrides, **tiny),
                              param_overrides=dict(TINY_PARAMS[cell["traffic"]],
                                                   **(params or {})))
