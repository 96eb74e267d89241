"""A whole run (the card's look aside) with the timed path broken underneath
comes out not correct: for each fault a cell can have."""
import importlib

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.portbench_tiny import make_run, render_cells


def _frames_without_shift(monkeypatch):
    """An answer altered where it is produced: each frame rendered from its
    code alone, the shift that moves it along the path dropped."""
    from warpedganspace_torch.traverse import engine

    render = engine._render_u8
    monkeypatch.setattr(engine, "_render_u8",
                        lambda G, c, s, w: render(G, c, torch.zeros_like(s), w))


def _directions_altered(monkeypatch):
    """An answer altered where it is produced: the warp's directions a
    little off (every component scaled by 1.01)."""
    from warpedganspace_torch.traverse import engine

    warp = engine.warp_grad_all_sets_kn
    monkeypatch.setattr(engine, "warp_grad_all_sets_kn", lambda ws, z, b: 1.01 * warp(ws, z, b))


def _stale_frames(monkeypatch):
    """An answer altered where it is produced: a batch's frames delivered
    from the batch before (a host buffer read before its copy landed)."""
    from warpedganspace_torch.traverse import engine

    finish, last = engine._finish, {}

    def stale(start, out, done, pad):
        got = finish(start, out, done, pad)
        prev = last.get("img")
        last["img"] = got[1].copy()
        if prev is not None and prev.shape == got[1].shape:
            return got[0], prev
        return got
    monkeypatch.setattr(engine, "_finish", stale)


@pytest.mark.parametrize("cell", render_cells())
@pytest.mark.parametrize("fault", [_frames_without_shift, _directions_altered, _stale_frames])
def test_a_render_fault_is_not_correct(cell, fault, monkeypatch):
    # Paths long enough at this size that a frame off its path shows.
    run = make_run(cell, params={"check_frames": 8, "eps": 2.0, "shift_steps": 3})
    fault(monkeypatch)
    res = bench_run.run_cell(run)
    assert not res["correct"], res["checks"]


TRAIN_LIMITS = {"loss_gap_steps": 1e-3, "update_gap": 2e-2}


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: both Adams skip their update."""
    ts = importlib.import_module("warpedganspace_torch.train.train_step")
    real = ts.make_optimizers

    def frozen(S, R, cfg):
        opts = real(S, R, cfg)
        for opt in opts:
            opt.step = lambda closure=None: None
        return opts
    monkeypatch.setattr(ts, "make_optimizers", frozen)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    ts = importlib.import_module("warpedganspace_torch.train.train_step")
    real = ts.train_step

    def half(state, iteration, batch=None):
        b = len(batch[0]) // 2
        return real(state, iteration, batch=tuple(t[:b] for t in batch))
    monkeypatch.setattr(ts, "train_step", half)


def test_the_training_run_is_correct_in_float32():
    """The training traffic at a tiny size with the program in float32, under
    the limits the fault tests use: correct (the cell is not in BENCHMARK.json
    yet: PERF.md, Open questions)."""
    run = make_run("sg2w1024-train-bf16", family="proggan",
                   params={"g_dtype": "float32", "r_dtype": "float32"})
    run.cell["limits"] = TRAIN_LIMITS
    res = bench_run.run_cell(run)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_training_fault_is_not_correct(fault, monkeypatch):
    run = make_run("sg2w1024-train-bf16", family="proggan",
                   params={"g_dtype": "float32", "r_dtype": "float32"})
    run.cell["limits"] = TRAIN_LIMITS
    fault(monkeypatch)
    res = bench_run.run_cell(run)
    assert not res["correct"], res["checks"]
