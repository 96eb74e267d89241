"""A new generator family enters the benchmark by new files and appended
entries alone: in a copy of ``benchmark/`` and ``BENCHMARK.json``, a family
module (a twin of ProgGAN's with its own operation count and tiny sizes), a
configuration, a render workload and their entries run through the
harness's own lookups and the copy's own tests, and no file that was there
changes."""
import hashlib
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

from benchmark.tests.portbench_tiny import BENCH_DIR, ROOT, bench

FAMILY, CONFIG, CELL = "progtwin", "progtwin-1024-z", "progtwin1024-render-bf16"
TWIN = '''"""A twin of ProgGAN under a name of its own: ProgGAN's weights, program
and reference, with its own operation count and tiny sizes."""
from benchmark.counts.generators import proggan_frame_flops
from benchmark.families.proggan import build_program, build_reference, make_weights  # noqa: F401

TINY = {"num_support_sets": 2, "num_support_dipoles": 4, "resolution": 32,
        "channels": [512, 16, 16, 8, 8, 8, 8, 8, 8]}


def frame_flops(cfg):
    return 2 * proggan_frame_flops(cfg)


def forward_flops(cfg):
    return frame_flops(cfg)
'''
# The copy's own tests that must take the new cell or configuration up.
TAKEN_UP = ("test_every_cell_resolves_by_name", "test_a_whole_run_at_a_tiny_size",
            "test_the_control_is_not_correct", "test_a_render_fault_is_not_correct",
            "test_generator_agrees", "test_the_family_counts_the_configuration",
            "test_step_count_adds_up_its_parts")
# A traced tiny run of the new cell: its result and the counts it should read.
TRACED = f'''import json
from benchmark import run as bench_run
from benchmark.counts.generators import frame_flops, proggan_frame_flops
from benchmark.counts.peaks import PEAK_BF16_FLOPS
from benchmark.tests.portbench_tiny import make_run
run = make_run({CELL!r}, trace=True)
res = bench_run.run_cell(run)
print(json.dumps({{"result": res, "frame_flops": frame_flops(run.config),
                  "proggan_flops": proggan_frame_flops(run.config), "peak": PEAK_BF16_FLOPS,
                  "family": run.family.__file__}}))
'''


def _digests(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = osp.join(dirpath, f)
            with open(path, "rb") as fh:
                out[osp.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add_family(copy, render_cells):
    """The new files, and the entries appended to the copy's BENCHMARK.json:
    the configuration, the cell, and the cell's name on every metric that
    every render cell reports."""
    (copy / "benchmark" / "families" / f"{FAMILY}.py").write_text(TWIN)
    with open(osp.join(BENCH_DIR, "configs", "proggan-celebahq1024-z.json")) as f:
        cfg = dict(json.load(f), name=CONFIG, family=FAMILY)
    (copy / "benchmark" / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    with open(osp.join(BENCH_DIR, "workloads", "proggan1024-render-bf16.json")) as f:
        cell = dict(json.load(f), config=CONFIG)
    (copy / "benchmark" / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    b = bench()
    b["configs"].append({"name": CONFIG, "source": "a twin of ProgGAN for a test",
                         "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                         "why": "a generator family the harness has not seen"})
    b["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "render", "chips": 1,
                           "why": "the ProgGAN render stream through a new family"})
    for m in b["end_to_end"] + b["per_layer"]:
        if set(render_cells) <= set(m.get("workloads", ())):
            m["workloads"].append(CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(b, indent=1))


def _run(copy, args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable] + args, cwd=copy, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def _without(entry, name):
    if "workloads" not in entry:
        return entry
    return dict(entry, workloads=[w for w in entry["workloads"] if w != name])


def test_a_new_family_is_files_and_entries_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = _digests(copy)
    render_cells = [w["name"] for w in bench()["workloads"] if w["traffic"] == "render"]
    _add_family(copy, render_cells)

    # The copy's own tests take the cell up: resolved by name, a tiny run
    # untraced and traced correct, the control and each fault not correct.
    report = _run(copy, ["-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                         "-o", "addopts=", "benchmark/tests", "-k", FAMILY])
    passed = re.findall(r"^PASSED \S+::(\w+)\[", report, re.M)
    assert set(TAKEN_UP) <= set(passed), report[-4000:]

    # render_mfu read from a traced window's counts: the new family's own.
    got = json.loads(_run(copy, ["-c", TRACED]).strip().splitlines()[-1])
    res = got["result"]
    assert res["correct"], res["checks"]
    assert got["family"] == str(copy / "benchmark" / "families" / f"{FAMILY}.py")
    assert got["frame_flops"] == 2 * got["proggan_flops"]
    want = 100.0 * res["attempted"] * got["frame_flops"] / res["device"]["window_s"] / got["peak"]
    assert abs(res["metrics"]["render_mfu"]["value"] - want) <= 1e-9 * want

    after = _digests(copy)
    changed = [p for p, d in before.items() if p != "BENCHMARK.json" and after.get(p) != d]
    assert not changed
    # BENCHMARK.json gained entries at the ends of its lists, and the old
    # entries gained the new cell's name and nothing else.
    old = bench()
    new = json.loads((copy / "BENCHMARK.json").read_text())
    for key, value in old.items():
        if isinstance(value, list) and value and isinstance(value[0], dict):
            assert [_without(e, CELL) for e in new[key][:len(value)]] == value, key
        else:
            assert new[key] == value, key
