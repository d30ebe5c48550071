"""The port's spans as ``torch.profiler`` ranges (``repro_torch.obs``).

With ``torch.profiler`` recording, every span opens the range
``race.<span>``, with obs on or off; with obs off that range is all a span
does, and with the profiler stopped a span is the shared no-op again.  The
entry point, the executor, K1's wrapper and the adjoint layer's backward
each have a span, nested as the calls are.  Runs on the CPU, where the
``"auto"`` backend takes K1's emulator through its wrapper.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.apps import get_case  # noqa: E402
from repro_torch.core.executor import clear_cache, env_to_torch  # noqa: E402
from repro_torch.core.race import race  # noqa: E402
from repro_torch.testing import build_env  # noqa: E402

pytestmark = [pytest.mark.port, pytest.mark.obs]

CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolated_port_obs(monkeypatch):
    for knob in (obs.ENV_OBS, obs.ENV_EVENTS, obs.ENV_RING, obs.ENV_SPANS):
        monkeypatch.delenv(knob, raising=False)
    obs.reset()
    yield
    obs.reset()


@pytest.fixture
def j3d():
    case = get_case("j3d27pt", 10)
    res = race(case.program, reassociate=case.reassociate)
    clear_cache()
    return res, env_to_torch(build_env(case, np.float32, seed=1), CPU)


def _ranges(prof, tmp_path):
    """The trace's ``race.`` ranges as ``(name without the prefix, thread,
    start, end)``, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"][len(obs.RANGE_PREFIX):], e["tid"], e["ts"],
            e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X"
           and e.get("name", "").startswith(obs.RANGE_PREFIX)]
    return sorted(out, key=lambda r: (r[2], -r[3]))


def _traced(fn, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert obs.tracing()
        fn()
    return _ranges(prof, tmp_path)


def _enclosing(ranges):
    """``[(name, the names of the ranges enclosing it on its thread,
    outermost first)]``."""
    out, open_ = [], {}
    for name, tid, lo, hi in ranges:
        stack = open_.setdefault(tid, [])
        while stack and stack[-1][1] <= lo:
            stack.pop()
        out.append((name, tuple(n for n, _ in stack)))
        stack.append((name, hi))
    return out


def _parents(ranges):
    """``[(name, the innermost range enclosing it on its thread, or
    None)]``."""
    return [(n, outer[-1] if outer else None)
            for n, outer in _enclosing(ranges)]


def _assert_obs_state_empty():
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}
    assert snap["gauges"] == {}
    assert obs.events() == [] and obs.span_records() == []


@pytest.mark.parametrize("call", ["run_batch", "run"])
def test_a_call_nests_entry_executor_and_k1_on_one_thread(call, j3d,
                                                          tmp_path):
    """Obs off: a first call and a second put ``entry`` (holding
    ``inputs``, ``lookup`` and the executor's ``compile``, then ``run``)
    into the trace, with ``k1`` inside the executor's span, all on one
    thread; obs's own state stays empty."""
    res, env = j3d
    args = [env, env] if call == "run_batch" else env

    def two_calls():
        for _ in range(2):
            getattr(res, call)(args, device=CPU)

    ranges = _traced(two_calls, tmp_path)
    assert len({tid for _, tid, _, _ in ranges}) == 1
    nested = [p for p in _parents(ranges) if p[0] != "lower"]
    call_ranges = [("entry", None), ("inputs", "entry"), ("lookup", "entry")]
    assert nested == (call_ranges + [("compile", "entry"), ("k1", "compile")]
                      + call_ranges + [("run", "entry"), ("k1", "run")])
    assert ("lower", "lookup") in _parents(ranges)  # the executor's build
    _assert_obs_state_empty()


def test_a_backward_runs_k1_inside_adjoint_backward(j3d, tmp_path):
    res, env = j3d
    leaves = {k: env[k].clone().requires_grad_() for k in ("u", "jc0")}

    def step():
        out = res.run({**env, **leaves}, device=CPU)
        torch.autograd.grad(sum(v.sum() for v in out.values()),
                            list(leaves.values()))

    ranges = _traced(step, tmp_path)
    assert [outer for n, outer in _enclosing(ranges)
            if n == "adjoint_backward"] == [()]
    # u's adjoint and jc0's, each its own K1 call inside the executor's
    inside = [outer for n, outer in _enclosing(ranges)
              if n == "k1" and "adjoint_backward" in outer]
    assert len(inside) == 2
    assert all(outer[-1] in ("run", "compile") for outer in inside)
    _assert_obs_state_empty()


def test_outside_the_profiler_a_span_is_the_shared_no_op():
    assert not obs.enabled() and not obs.tracing()
    assert obs.span("entry") is obs.NOOP_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert obs.tracing()
        assert obs.span("entry") is not obs.NOOP_SPAN
    assert not obs.tracing()
    assert obs.span("entry") is obs.NOOP_SPAN
    obs.configure(enabled=True)
    assert obs.tracing()


def test_obs_on_records_the_ports_spans_without_labels(j3d):
    """With obs on and no profiler the port's own spans reach the summary
    and the span log, with no labels (``race_span_seconds`` keeps the label
    keys ``(path, span)`` for them)."""
    res, env = j3d
    obs.configure(enabled=True)
    for _ in range(2):
        res.run_batch([env, env], device=CPU)
    summary = obs.span_summary()
    assert set(obs.PORT_SPANS) <= set(summary)
    assert summary["entry"]["count"] == summary["inputs"]["count"] == 2
    assert summary["k1"]["count"] == 2
    recs = {r["path"]: r for r in obs.span_records()}
    assert {"entry", "entry/inputs", "entry/lookup", "entry/lookup/lower",
            "entry/compile/k1", "entry/run/k1"} <= set(recs)
    for name in obs.PORT_SPANS:
        assert all(r["labels"] == {} for r in recs.values()
                   if r["name"] == name)
    series = obs.snapshot()["histograms"]
    assert "race_span_seconds{path=entry/inputs,span=inputs}" in series


def test_obs_on_under_the_profiler_does_both(j3d, tmp_path):
    res, env = j3d
    obs.configure(enabled=True)
    ranges = _traced(lambda: res.run(env, device=CPU), tmp_path)
    names = {r[0] for r in ranges}
    assert set(obs.PORT_SPANS) <= names and "compile" in names
    assert {r["name"] for r in obs.span_records()} == names
