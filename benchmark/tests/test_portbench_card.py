"""The cells on the card at their own sizes, a short window each: correct,
and the control not (run on the chip: ``python -m pytest benchmark/tests -m gpu``)."""
import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.test_portbench_harness import bench

CELLS = [w["name"] for w in bench()["workloads"] if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_its_control_is_not(cell, card):
    run = bench_run.make_run(cell, 2 ** 33 + 101, 2.0, False, card)
    st = run.traffic.setup(run)
    out = run.traffic.window(run, st)
    assert out["work"]["frames"] > 0
    outputs = run.traffic.outputs(run, st)
    del st
    torch.cuda.empty_cache()
    checks = run.traffic.check(run, outputs)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    control = run.traffic.control(run, outputs)
    assert any(control[k] > v for k, v in run.cell["limits"].items()), control
