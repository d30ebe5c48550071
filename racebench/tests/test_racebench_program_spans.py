"""The readers of the port's own spans in the traced window
(``progspans.py`` and the six ``layers/`` files that use it): exact values
on a trace built by hand, None on a trace with no span, and the values a
traced run reads, on the CPU and (marked ``cuda``) on a card:

    python -m pytest -q -m cuda racebench/tests/test_racebench_program_spans.py
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent / "src", HERE, HERE / "tests"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import devtrace  # noqa: E402
import drive  # noqa: E402
import progspans  # noqa: E402
from test_racebench_harness import host_side, small_cell  # noqa: E402

BENCH = benchspec.load()
BATCH, GRAD = "j3d27pt.batch64x256", "j3d27pt.grad512"
#: the six metrics' entries, as ``per_layer`` in ``BENCHMARK.json`` would
#: hold them
ENTRIES = [
    {"name": "entry_us.batch", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "entry", "moves": "batch_p95_ms",
     "workloads": [BATCH]},
    {"name": "executor_us.batch", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "executor", "moves": "batch_p95_ms",
     "workloads": [BATCH]},
    {"name": "k1_host_us.batch", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "kernels", "moves": "batch_p95_ms",
     "workloads": [BATCH]},
    {"name": "idle_in_program.batch", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device", "moves": "batch_p95_ms",
     "workloads": [BATCH]},
    {"name": "adjoint_us.grad", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "adjoint", "moves": "grad_gpts",
     "workloads": [GRAD]},
    {"name": "k1_calls.grad", "unit": "calls", "better": "lower",
     "source": "program_span", "layer": "adjoint", "moves": "grad_gpts",
     "workloads": [GRAD]},
]
NAMES = [m["name"] for m in ENTRIES]


def read(name, trace):
    return benchspec.module("layers", name).read(SimpleNamespace(trace=trace))


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _span(name, ts, dur, tid=1, cat="cpu_op"):
    return _ev(cat, progspans.PREFIX + name, ts, dur, tid)


HARNESS = [
    _ev("user_annotation", "racebench.window", 0, 1000),
    _ev("user_annotation", "racebench.forward", 100, 300),
    _ev("user_annotation", "racebench.forward", 500, 300),
    _ev("user_annotation", "racebench.backward", 850, 100),
    _ev("user_annotation", "racebench.forward", 1050, 100),  # after it
]

EVENTS = HARNESS + [
    # call 1, thread 1: self entry 30, inputs 20, lookup 20, run 90, k1 120
    _span("entry", 110, 280, cat="user_annotation"),
    _span("inputs", 115, 20),
    _ev("cpu_op", "aten::stack", 120, 10),
    _span("lookup", 140, 20),
    _span("run", 170, 210),
    _span("k1", 180, 120),
    _ev("cpu_op", "aten::empty", 190, 5),
    _ev("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=1),
    # thread 2, at the same time: its own top level
    _span("lookup", 200, 20, tid=2),
    # call 2: self entry 30, inputs 10, lookup 10, compile 60, k1 80
    _span("entry", 510, 190, cat="user_annotation"),
    _span("inputs", 515, 10),
    _span("lookup", 530, 10),
    _span("compile", 550, 140),
    _span("k1", 560, 80),
    _ev("cuda_runtime", "cudaLaunchKernel", 600, 5, correlation=2),
    # a backward on autograd's thread: self 25, two K1 calls (run self
    # 10 + 10, k1 20 + 15)
    _span("adjoint_backward", 860, 80, tid=2),
    _span("run", 870, 30, tid=2),
    _span("k1", 875, 20, tid=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 880, 5, tid=2, correlation=3),
    _span("run", 905, 25, tid=2),
    _span("k1", 910, 15, tid=2),
    # outside the window
    _span("entry", 1100, 50),
    _span("k1", 1110, 20),
    # the card: busy 300-450, 650-750, 900-920
    _ev("kernel", "race_stencil_kernel", 300, 150, tid=7, correlation=1),
    _ev("kernel", "race_stencil_kernel", 650, 100, tid=7, correlation=2),
    _ev("kernel", "race_stencil_kernel", 900, 20, tid=7, correlation=3),
]


def test_the_readers_give_the_hand_counted_values():
    tr = devtrace.Trace(EVENTS)
    got = {n: read(n, tr) for n in NAMES}
    assert got == {
        "entry_us.batch": pytest.approx((30 + 20 + 30 + 10) / 2),
        "executor_us.batch": pytest.approx(
            ((20 + 10 + 20) + 90 + 60 + (10 + 10)) / 2),
        "k1_host_us.batch": pytest.approx((120 + 80 + 20 + 15) / 2),
        # inside race.* spans 110-390, 510-700, 860-940 (550 µs), of which
        # the card is busy 300-390, 650-700, 900-920 (160 µs)
        "idle_in_program.batch": pytest.approx(100 * (550 - 160) / 1000),
        "adjoint_us.grad": pytest.approx(25.0),
        "k1_calls.grad": 2.0,
    }
    run = SimpleNamespace(trace=tr)
    assert got["idle_in_program.batch"] <= 100 * (
        1 - tr.busy_s() / tr.window_s())
    assert (benchspec.module("layers", "device_idle.batch").read(run)
            == pytest.approx(73.0))


def test_a_span_is_nested_on_its_own_thread_only():
    by = {(s.name, s.start): s for s in progspans.spans(
        devtrace.Trace(EVENTS))}
    assert by["k1", 180].parent is by["run", 170]
    assert by["run", 170].parent is by["entry", 110]
    assert by["lookup", 200].parent is None  # thread 2, inside no span
    assert by["k1", 875].within("adjoint_backward")
    assert not by["k1", 180].within("adjoint_backward")
    assert ("entry", 1100) not in by


def test_a_trace_without_the_ports_spans_reads_nothing():
    tr = devtrace.Trace([e for e in EVENTS
                         if not e["name"].startswith(progspans.PREFIX)])
    assert {n: read(n, tr) for n in NAMES} == dict.fromkeys(NAMES)
    assert read("entry_us.batch", None) is None


def test_a_backward_without_k1_reads_zero_calls():
    events = HARNESS + [_span("adjoint_backward", 860, 80, tid=2),
                        _ev("cpu_op", "aten::fill_", 870, 10, tid=2)]
    tr = devtrace.Trace(events)
    assert read("k1_calls.grad", tr) == 0.0
    assert read("adjoint_us.grad", tr) == pytest.approx(80.0)


def test_the_entries_keep_the_benchmarks_rules():
    bench = {**BENCH, "per_layer": BENCH["per_layer"] + ENTRIES}
    assert benchspec.problems(bench) == []


@pytest.mark.parametrize("name", [BATCH, GRAD])
def test_a_traced_cpu_run_reads_the_host_metrics(name):
    """A CPU run at a tiny extent, where K1 is the emulator behind its
    wrapper: each host metric of the cell reads a value (the device one
    has no device activity to read here)."""
    cell = host_side(small_cell(name))
    mine = [m for m in ENTRIES
            if name in m["workloads"] and m["source"] != "device_trace"]
    cell.per_layer = cell.per_layer + mine
    line = drive.measure(cell, 2 ** 31 + 19, 0.3, True, "cpu")
    assert line["correct"] is True
    got = {m["name"]: line["metrics"][m["name"]]["value"] for m in mine}
    assert all(v > 0 for v in got.values()), got
    if name == GRAD:
        assert got["k1_calls.grad"] == 2.0  # u's adjoint, the scalars' group


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_traced_card_run_ties_each_k1_kernel_to_a_k1_span(card):
    cell = benchspec.cell(BENCH, BATCH)
    run = drive.Run(cell, 2 ** 31 + 23, "cuda", traced=True)
    run.setup()
    run.window(2.0)
    got = {m["name"]: benchspec.module("layers", m["name"]).read(run)
           for m in ENTRIES if BATCH in m["workloads"]}
    idle = benchspec.module("layers", "device_idle.batch").read(run)
    print(BATCH, got, "device_idle.batch", idle)
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["idle_in_program.batch"] <= idle
    k1 = [s for s in progspans.spans(run.trace) if s.name == "k1"]
    win = run.trace.window()
    launched = [at for e, at in zip(run.trace.device, run.trace.launched)
                if "race_stencil_kernel" in e["name"]
                and win[0] <= e["ts"] <= win[1]]
    assert launched
    assert all(at is not None and any(s.start <= at <= s.end for s in k1)
               for at in launched)
