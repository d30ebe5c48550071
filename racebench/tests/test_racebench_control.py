"""The control fails each cell's limits, and the program passes them.

The control is the plain reference computed in the cell's
``control_dtype`` (bfloat16 for float32, float32 for float64) in the
program's place, held
against the float64 reference by the same numbers a run compares.  Here it
runs on the CPU at a tiny extent; ``calibrate.py`` reads it on the card at
each cell's own size, where the limits were set from.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import drive  # noqa: E402
import verdict  # noqa: E402

BENCH = benchspec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(name):
    cell = benchspec.cell(BENCH, name)
    tr = {**cell.traffic, "extent": 16}
    if tr["batch"]:
        tr["batch"] = 4
    cell.traffic = tr
    return cell


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 1, 2 ** 33 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name, seed):
    cell = small(name)
    prog = cell.program()
    inputs = drive.draw_inputs(cell, seed, "cpu")
    got = verdict.control(cell, prog, cell.kind(), inputs)
    assert set(got) == set(cell.limits)
    assert any(got[k] > cell.limits[k] for k in got), got


def test_each_control_dtype_is_the_precision_below_the_cells():
    below = {"float64": "float32", "float32": "bfloat16"}
    for name in CELLS:
        cell = benchspec.cell(BENCH, name)
        assert cell.control_dtype == below[cell.traffic["dtype"]], name


@pytest.mark.parametrize("name", CELLS)
def test_the_limits_lie_between_the_program_and_the_control(name):
    """At this extent the program's readings sit far under each limit and
    the control's far over at least one."""
    cell = small(name)
    line = drive.measure(cell, 2 ** 31 + 29, 0.2, False, "cpu")
    prog = cell.program()
    inputs = drive.draw_inputs(cell, 2 ** 31 + 29, "cpu")
    ctrl = verdict.control(cell, prog, cell.kind(), inputs)
    for k, c in line["checks"].items():
        assert c["value"] * 10 < c["limit"]
    assert max(ctrl[k] / cell.limits[k] for k in ctrl) > 10
