"""The control fails each cell's limits, and the program passes them.

The control is the plain reference computed in the cell's
``control_dtype`` (bfloat16 for float32, float32 for float64,
``float8_e4m3fn`` for bfloat16, whose arithmetic the control rounds
operation by operation) in the program's place, held
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
#: the factor by which the program's readings sit under each limit and the
#: control's over one: 10, but 4 for a bfloat16 cell, whose 8 significand
#: bits lie only 4 above its float8_e4m3fn control's (unit roundoffs 16
#: times apart, so about 4 on each side)
MARGIN = {"bfloat16": 4}


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
    below = {"float64": "float32", "float32": "bfloat16",
             "bfloat16": "float8_e4m3fn"}
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
    m = MARGIN.get(cell.traffic["dtype"], 10)
    for k, c in line["checks"].items():
        assert c["value"] * m < c["limit"]
    assert max(ctrl[k] / cell.limits[k] for k in ctrl) > m


def test_the_float8_control_rounds_every_result_as_float8_e4m3fn():
    """Under the control's rounding a known value comes out as
    ``float8_e4m3fn`` holds it (3 stored significand bits), carried in
    float32; each operation's result is rounded again."""
    e4m3 = torch.float8_e4m3fn
    with verdict.Rounding(e4m3):
        x = torch.tensor([0.3, 1 / 3, 17.0, -0.7], dtype=torch.float64)
        y = x * torch.tensor(3.0)
        parts = torch.tensor([1.1, 2.2]).split(1)
    assert x.dtype == y.dtype == torch.float32
    assert [float(p) for p in parts] == [1.125, 2.25]
    assert x.tolist() == [0.3125, 0.34375, 16.0, -0.6875]
    # 0.9375 is exact; 1.03125 rounds to 1.0, 48.0 stays, -2.0625 to -2.0
    assert y.tolist() == [0.9375, 1.0, 48.0, -2.0]
    assert x.tolist() == x.to(e4m3).float().tolist()
