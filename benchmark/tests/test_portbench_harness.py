"""The harness: BENCHMARK.json against the contract and the files it names,
a whole run of each cell at a tiny size on the CPU, and what the run may
import."""
import importlib
import json
import os
import os.path as osp
import re
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.portbench_tiny import BENCH_DIR, ROOT, bench, make_run, render_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FOREIGN = ("jax", "jaxlib", "flax", "warpedganspace_tpu")


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][-1] == "benchmark.run" and len(b["command"]) <= 32
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and osp.isfile(osp.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        with open(osp.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", ())) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    """Workload file, configuration file, family and traffic modules, and a
    reader for each of the cell's per-layer metrics; every cell reports
    set-up, another end-to-end metric and a per-layer metric, and each
    per-layer metric the end-to-end metric it moves."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    run = bench_run.make_run(cell, 1, 1, False, torch.device("cpu"))
    assert run.cell["config"] == w["config"] and run.cell["traffic"] == w["traffic"]
    assert run.cell["chips"] == w["chips"] and run.cell["limits"]
    assert run.config["name"] == w["config"]
    for fn in ("setup", "window", "outputs", "check", "control", "gaps"):
        assert callable(getattr(run.traffic, fn))
    for fn in ("make_weights", "build_program", "build_reference", "frame_flops",
               "forward_flops"):
        assert callable(getattr(run.family, fn))
    assert isinstance(run.family.TINY, dict)
    e2e, per_layer = bench_run.cell_metrics(b, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(bench_run.reader(m["name"]).read)


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path, monkeypatch):
    """A cell added as a new workload file (and a BENCHMARK.json entry), with
    a per-layer metric listing it, runs through the same harness: nothing
    that exists is edited."""
    wl = tmp_path / "workloads"
    wl.mkdir()
    for name in os.listdir(osp.join(BENCH_DIR, "workloads")):
        (wl / name).write_text(open(osp.join(BENCH_DIR, "workloads", name)).read())
    cell = json.load(open(osp.join(BENCH_DIR, "workloads", "sg2w1024-render-bf16.json")))
    cell["params"]["batch"] = 8
    (wl / "sg2w1024-render-b8.json").write_text(json.dumps(cell))
    (tmp_path / "configs").symlink_to(osp.join(BENCH_DIR, "configs"))
    monkeypatch.setattr(bench_run, "BENCH_DIR", str(tmp_path))
    run = bench_run.make_run("sg2w1024-render-b8", 3, 1, False, torch.device("cpu"))
    assert run.params["batch"] == 8 and run.traffic.__name__ == "benchmark.traffic.render"
    b = bench()
    b["workloads"].append({"name": "sg2w1024-render-b8", "config": "stylegan2-ffhq1024-w",
                           "traffic": "render", "chips": 1, "why": "a smaller batch"})
    b["per_layer"].append({"name": "device_idle_pct.render", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "render_frames_per_s"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("sg2w1024-render-b8")
    e2e, per_layer = bench_run.cell_metrics(b, "sg2w1024-render-b8")
    assert {"setup_s", "render_frames_per_s"} <= {m["name"] for m in e2e}
    assert "device_idle_pct.render" in {m["name"] for m in per_layer}


@pytest.mark.parametrize("cell", render_cells())
@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_at_a_tiny_size(cell, trace):
    """Set-up, window, check and the result object, on the CPU: correct, the
    end-to-end metrics untraced; traced, the window and breakdown read, and
    the per-layer metrics of the port's spans found."""
    run = make_run(cell, trace=trace)
    res = bench_run.run_cell(run)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
        assert "render_frames_per_s" not in res["metrics"]
        assert res["metrics"]["host_issue_ms_per_batch.render"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"setup_s", "render_frames_per_s"}


def test_no_card_no_result(capsys):
    """Without a CUDA card the command exits non-zero and prints no result."""
    assert not torch.cuda.is_available()
    assert bench_run.main(["--workload", "sg2w1024-render-bf16", "--seed", "1",
                           "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def _fresh_modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _benchmark_modules() -> list:
    names = []
    for dirpath, _, files in os.walk(BENCH_DIR):
        rel = osp.relpath(dirpath, ROOT).replace(os.sep, ".")
        if rel.endswith("tests"):
            continue
        names += [f"{rel}.{f[:-3]}" for f in files if f.endswith(".py") and f != "__init__.py"]
    return sorted(names)


def test_the_benchmark_imports_no_jax():
    """Every module of the benchmark (the tests aside), and the program it
    drives, imported in a fresh interpreter: no module whose top-level name
    is JAX's, Flax's or the JAX package's."""
    names = _benchmark_modules()
    assert "benchmark.run" in names and "benchmark.traffic.render" in names
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "import warpedganspace_torch.traverse.engine, warpedganspace_torch.train.train_step\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    mods = _fresh_modules(code)
    assert not [m for m in mods if m.split(".")[0] in FOREIGN]


def test_the_reference_imports_nothing_of_the_program():
    """``benchmark/reference`` imported alone: no module of the port."""
    names = [n for n in _benchmark_modules() if n.startswith("benchmark.reference.")]
    assert len(names) >= 6
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    mods = _fresh_modules(code)
    assert not [m for m in mods if m.split(".")[0] in FOREIGN + ("warpedganspace_torch",)]
    pattern = re.compile(r"^\s*(import|from)\s+(\w+)")
    for f in os.listdir(osp.join(BENCH_DIR, "reference")):
        if f.endswith(".py"):
            for line in open(osp.join(BENCH_DIR, "reference", f)):
                m = pattern.match(line)
                assert not (m and m.group(2) in FOREIGN + ("warpedganspace_torch",)), line


def test_foreign_modules_are_found_by_their_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    found = bench_run.foreign_modules()
    assert "jaxlib.xla_client" in found and "jaxtyping" not in found
    assert importlib.import_module("warpedganspace_torch").__name__ not in found
