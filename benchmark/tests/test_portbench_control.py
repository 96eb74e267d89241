"""Each cell's control, the plain reference one precision below the
configuration's put in the program's place, comes out not correct under the
cell's own limits (at a tiny size on the CPU; on the card at the cells' own
sizes by ``python3 -m benchmark.calibrate``)."""
import pytest

from benchmark.tests.portbench_tiny import make_run
from benchmark.tests.test_portbench_harness import bench


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_the_control_is_not_correct(cell):
    run = make_run(cell)
    st = run.traffic.setup(run)
    run.traffic.window(run, st)
    out = run.traffic.outputs(run, st)
    program = run.traffic.gaps(run, out)
    control = run.traffic.control(run, out)
    limits = run.cell["limits"]
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
