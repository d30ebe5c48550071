"""The frozen counts of bytes and operations of each cell, and the bound
they give, pinned; and the counts against the frozen source programs."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import peaks  # noqa: E402

# (cell, what, bytes, operations, bound in seconds, what binds)
TABLE = [
    ("j3d27pt.sweep512", "forward", 1_067_474_912, 7_163_154_000,
     0.00031864922746268655, "bytes"),
    ("psinv.sweep514.f64", "forward", 3_246_489_728, 4_160_749_568,
     0.0009691014113432835, "bytes"),
    ("j3d27pt.batch64x256", "forward", 512_483_328, 3_294_646_272,
     0.00015298009791044775, "bytes"),
    ("j3d27pt.grad512", "forward", 1_067_474_912, 7_163_154_000,
     0.00031864922746268655, "bytes"),
    ("j3d27pt.grad512", "backward", 1_604_345_824, 11_540_637_000,
     0.0004789092011940298, "bytes"),
    ("j3d27pt.sweep512.bf16", "forward", 533_737_456, 7_163_154_000,
     0.00015932461373134327, "bytes"),
    ("poisson.sweep512", "forward", 1_067_474_912, 2_785_671_000,
     0.00031864922746268655, "bytes"),
]


def _work(cell_name, what):
    cell = benchspec.cell(benchspec.load(), cell_name)
    tr = cell.traffic
    item = peaks.ITEMSIZE[tr["dtype"]]
    fn = getattr(cell.work(), what)
    return fn(tr["extent"], item, tr["batch"] or 1), tr["dtype"]


@pytest.mark.parametrize("cell,what,nbytes,ops,bound_s,binds", TABLE)
def test_counts_and_bound_are_pinned(cell, what, nbytes, ops, bound_s, binds):
    (b, o), dtype = _work(cell, what)
    assert (b, o) == (nbytes, ops)
    s, by = peaks.bound(b, o, dtype)
    assert s == pytest.approx(bound_s, rel=1e-12)
    assert by == binds


def test_bounds_in_milliseconds():
    got = {}
    for c, w, *_ in TABLE:
        (b, o), dtype = _work(c, w)
        got[c, w] = round(peaks.bound(b, o, dtype)[0] * 1e3, 4)
    assert got == {("j3d27pt.sweep512", "forward"): 0.3186,
                   ("psinv.sweep514.f64", "forward"): 0.9691,
                   ("j3d27pt.batch64x256", "forward"): 0.153,
                   ("j3d27pt.grad512", "forward"): 0.3186,
                   ("j3d27pt.grad512", "backward"): 0.4789,
                   ("j3d27pt.sweep512.bf16", "forward"): 0.1593,
                   ("poisson.sweep512", "forward"): 0.3186}


def test_psinv_operations_alone_would_take_far_less_than_its_bytes():
    (b, o), dtype = _work("psinv.sweep514.f64", "forward")
    assert o / peaks.PEAK_FLOPS[dtype] == pytest.approx(1.2420148e-4,
                                                         rel=1e-6)
    assert b / peaks.HBM_BYTES_PER_S > 7 * o / peaks.PEAK_FLOPS[dtype]


def _ops(expr, Node):
    if not isinstance(expr, Node):
        return 0
    return 1 + sum(_ops(k, Node) for k in expr.kids)


@pytest.mark.parametrize("name", ["j3d27pt", "psinv", "poisson"])
def test_counts_follow_the_frozen_source_program(name):
    """Operations a point are the frozen program's own, points are its
    iteration space, and the byte count's arrays and outputs are its."""
    from repro_torch.core.ir import Node

    prog = benchspec.module("programs", name)
    work = benchspec.module("work", name)
    n = 11
    p = prog.build(n)
    assert sum(_ops(st.rhs, Node) for st in p.body) == work.OPS_PER_POINT
    assert p.volume() == work.points(n)
    assert (work.ARRAYS, work.OUTPUTS, work.HALO) == (
        len(prog.ARRAYS), len(prog.OUTPUTS), prog.HALO)
    assert {st.lhs.name for st in p.body} == set(prog.OUTPUTS)


@pytest.mark.parametrize("name,base", [
    ("j3d27pt", {"+": 26, "*": 27, "/": 1}),
    ("psinv", {"+": 27, "*": 4}),
    ("poisson", {"+": 16, "-": 2, "*": 3}),
])
def test_source_counts_are_the_papers_base(name, base):
    from repro_torch.core.ir import Node

    p = benchspec.module("programs", name).build(8)
    ops = {}

    def walk(e):
        if isinstance(e, Node):
            ops[e.op] = ops.get(e.op, 0) + 1
            for k in e.kids:
                walk(k)

    walk(p.body[0].rhs)
    assert ops == base
