"""Tiny sizes of the benchmark's cells for the CPU tests: the same code paths
with small widths, so that a whole run fits in a few seconds."""
from __future__ import annotations

import json
import os.path as osp

import torch

from benchmark import run as bench_run

CPU = torch.device("cpu")
BENCH_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))


def config(name: str) -> dict:
    with open(osp.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


# StyleGAN2 at 8x8 (its 512-channel 4x4 and 8x8 blocks), ProgGAN as a 64x64
# chain of 8 to 32 channels; both with 3 sets of 4 dipoles.
SETS = {"num_support_sets": 3, "num_support_dipoles": 4}
TINY_CONFIGS = {
    "stylegan2": dict(SETS, resolution=8),
    "proggan": dict(SETS, resolution=64, channels=[512, 32, 32, 16, 16, 16, 16, 8, 8, 8, 8]),
}
TINY_PARAMS = {
    "render": {"codes": 2, "shift_steps": 2, "batch": 4, "check_frames": 4},
    "train": {"batch": 4, "log_freq": 2},
}


def make_run(workload: str, seed: int = 2 ** 33 + 17, seconds: float = 0.3, trace: bool = False,
             family: str | None = None, params: dict | None = None):
    """``workload`` at its tiny size on the CPU (``family`` swaps in the other
    generator family's tiny configuration)."""
    with open(osp.join(BENCH_DIR, "workloads", workload + ".json")) as f:
        cell = json.load(f)
    cfg = config(cell["config"])
    overrides = {}
    if family is not None and family != cfg["family"]:
        other = {"stylegan2": "stylegan2-ffhq1024-w", "proggan": "proggan-celebahq1024-z"}[family]
        overrides = config(other)
    overrides.update(TINY_CONFIGS[family or cfg["family"]])
    return bench_run.make_run(workload, seed, seconds, trace, CPU, config_overrides=overrides,
                              param_overrides=dict(TINY_PARAMS[cell["traffic"]], **(params or {})))
