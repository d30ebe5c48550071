"""The port's observability layer, ``repro_torch.obs``, against the
reference's ``repro.obs``.

The cases of ``tests/test_obs.py`` on the port's own copy (the primitives,
the no-op disabled path, one structured event per pipeline decision, dump
and report), plus a parity test: the same sequence of calls in both
packages with obs on gives the same metric names and label keys, event
kinds, span names and ``telemetry()`` identities.

``tests/conftest.py`` isolates only the reference's state, so this file
resets the port's around every test and clears the ``RACE_OBS*`` knobs,
which both packages read.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import obs as ref_obs
from repro.core import adjoint as ref_adjoint
from repro.apps.paper_kernels import get_case as ref_get_case
from repro.core.adjoint import adjoint_build as ref_adjoint_build
from repro.core.backend import select_backend as ref_select_backend
from repro.core.executor import clear_cache as ref_clear_cache
from repro.core.executor import compile_plan as ref_compile_plan
from repro.core.ir import arr as ref_arr
from repro.core.ir import loopnest as ref_loopnest
from repro.core.ir import program as ref_program
from repro.core.race import race as ref_race
from repro.testing.differential import build_env as ref_build_env
from repro_torch import obs
from repro_torch.core import adjoint as port_adjoint
from repro_torch.apps.paper_kernels import get_case
from repro_torch.core.adjoint import adjoint_build
from repro_torch.core.backend import select_backend
from repro_torch.core.executor import (clear_cache, compile_plan,
                                       configure_cache, env_to_torch,
                                       plan_hash)
from repro_torch.core.ir import arr, loopnest, program
from repro_torch.core.race import race
from repro_torch.frontend import D_CONTROL_FLOW, CaptureError, capture
from repro_torch.obs import report
from repro_torch.obs.metrics import DEFAULT_BUCKETS, Histogram, Registry
from repro_torch.testing import SWEEP_SIZES, build_env
from test_torch_seed import (PLAN_KEYS, SEED_DEPENDENT_PLANS,
                             reference_under_seed0)

pytestmark = [pytest.mark.port, pytest.mark.obs]

CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolated_port_obs(monkeypatch):
    for knob in (obs.ENV_OBS, obs.ENV_EVENTS, obs.ENV_RING, obs.ENV_SPANS):
        monkeypatch.delenv(knob, raising=False)
    obs.reset()
    yield
    obs.reset()


def _enable(**kw):
    obs.configure(enabled=True, **kw)


def _cpu_env(case, dtype=np.float32):
    return env_to_torch(build_env(case, dtype), CPU)


# ---------------------------------------------------------------------------
# primitives: registry, histogram, spans, events
# ---------------------------------------------------------------------------


def test_registry_counter_thread_safety():
    reg = Registry()
    n_threads, n_incs = 8, 1000

    def worker():
        for _ in range(n_incs):
            reg.counter("c", plan="p").inc()

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert reg.counter("c", plan="p").value == n_threads * n_incs


def test_registry_series_identity_and_label_order():
    reg = Registry()
    a = reg.counter("c", x="1", y="2")
    b = reg.counter("c", y="2", x="1")  # label order must not matter
    assert a is b
    assert reg.counter("c", x="1", y="3") is not a


def test_histogram_bucket_edges():
    h = Histogram(edges=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0):
        h.observe(v)
    h.observe(10.0)
    h.observe(99.0)
    h.observe(1e6)  # overflow
    assert h.bucket_counts() == [2, 1, 1, 1]
    snap = h.snapshot()
    assert snap["count"] == 5
    assert snap["min"] == 0.5 and snap["max"] == 1e6
    assert h.quantile(0.5) == 10.0


def test_default_buckets_equal_the_reference():
    assert DEFAULT_BUCKETS[0] == pytest.approx(1e-6)
    assert DEFAULT_BUCKETS[-1] == pytest.approx(100.0)
    assert len(DEFAULT_BUCKETS) == 33  # quarter-decade over 8 decades
    assert DEFAULT_BUCKETS == ref_obs.DEFAULT_BUCKETS


def test_histogram_rejects_unsorted_edges():
    with pytest.raises(ValueError):
        Histogram(edges=(1.0, 1.0, 2.0))


def test_knobs_and_defaults_equal_the_reference():
    for name in ("ENV_OBS", "ENV_EVENTS", "ENV_RING", "ENV_SPANS",
                 "OBS_SCHEMA", "DEFAULT_RING", "DEFAULT_SPAN_RING"):
        assert getattr(obs, name) == getattr(ref_obs, name), name
    assert set(obs.__all__) == set(ref_obs.__all__)


def test_span_nesting_records_leaf_and_path():
    _enable()
    with obs.span("a"):
        assert obs.current_path() == "a"
        with obs.span("b"):
            assert obs.current_path() == "a/b"
            time.sleep(0.001)
    assert obs.current_path() == ""
    series = obs.snapshot()["histograms"]
    assert any("span=a" in s for s in series)
    inner = [s for s in series if "span=b" in s]
    assert inner and all("path=a/b" in s for s in inner)
    summary = obs.span_summary()
    assert summary["b"]["count"] == 1
    assert summary["b"]["total_s"] >= 0.001


def test_span_records_on_exception():
    _enable()
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    assert obs.span_summary()["boom"]["count"] == 1
    assert obs.current_path() == ""


def test_event_jsonl_roundtrip(tmp_path):
    sink = tmp_path / "events.jsonl"
    _enable(events_path=str(sink))
    obs.event("executor_build", plan="abcd", backend="hopper")
    obs.event("backend_fallback", plan="abcd", reasons=["mixed-stride: x"])
    ring = obs.events()
    assert [e["seq"] for e in ring] == [1, 2]
    assert obs.load_jsonl(sink) == ring
    assert obs.events(kind="executor_build")[0]["backend"] == "hopper"
    assert obs.event_log().counts() == {"executor_build": 1,
                                        "backend_fallback": 1}


def test_event_ring_is_bounded(monkeypatch):
    monkeypatch.setenv(obs.ENV_RING, "4")
    monkeypatch.setenv(obs.ENV_OBS, "1")
    obs.reset()
    for i in range(10):
        obs.event("k", i=i)
    evs = obs.events()
    assert [e["i"] for e in evs] == [6, 7, 8, 9]
    assert evs[-1]["seq"] == 10


def test_broken_sink_degrades_to_ring_only(tmp_path):
    _enable(events_path=str(tmp_path / "no-such-dir" / "e.jsonl"))
    obs.event("k", i=0)
    obs.event("k", i=1)
    log = obs.event_log()
    assert log.sink_errors == 1
    assert log.sink_path is None
    assert len(obs.events()) == 2


def test_event_coerces_non_json_fields():
    _enable()
    ev = obs.event("k", arr=np.float32(1.5), tup=(1, 2), obj=object(),
                   t=torch.tensor(2.0))
    assert ev["arr"] == "1.5" or ev["arr"] == 1.5
    assert ev["tup"] == [1, 2]
    assert isinstance(ev["obj"], str)
    json.dumps(ev)


def test_prometheus_exposition():
    _enable()
    obs.counter("race_builds_total", reassociate="3").inc()
    obs.gauge("race_reduced_ops", plan="ab").set(0.5)
    obs.histogram("race_span_seconds", span="run", path="run").observe(1e-4)
    text = obs.render_prometheus()
    assert "# TYPE race_builds_total counter" in text
    assert 'race_builds_total{reassociate="3"} 1' in text
    assert "# TYPE race_reduced_ops gauge" in text
    assert "# TYPE race_span_seconds histogram" in text
    assert 'le="+Inf"} 1' in text
    doc = json.loads(obs.render_json())
    assert doc["counters"]["race_builds_total{reassociate=3}"] == 1


def test_prometheus_label_value_escaping():
    _enable()
    obs.counter("c", path='a"b\\c\nd').inc()
    text = obs.render_prometheus()
    assert 'c{path="a\\"b\\\\c\\nd"} 1' in text
    for line in text.splitlines():
        assert line.startswith(("#", "c{"))


def test_prometheus_histogram_buckets_are_cumulative_monotone():
    _enable()
    h = obs.histogram("race_span_seconds", span="run", path="run")
    for v in (5e-7, 1e-4, 1e-4, 0.5, 200.0):
        h.observe(v)
    counts = [int(line.rsplit(" ", 1)[1])
              for line in obs.render_prometheus().splitlines()
              if line.startswith("race_span_seconds_bucket")]
    assert len(counts) >= 2
    assert counts == sorted(counts)
    assert counts[-1] == 5


def test_snapshot_label_filter():
    _enable()
    obs.counter("c", plan="a").inc()
    obs.counter("c", plan="b").inc(2)
    snap = obs.snapshot(label_filter={"plan": "a"})
    assert list(snap["counters"]) == ["c{plan=a}"]


def test_configure_keeps_history_reset_drops_it():
    _enable()
    obs.counter("c").inc()
    obs.event("k")
    obs.configure(ring=8)
    assert len(obs.events()) == 1
    assert obs.metrics().counter("c").value == 1
    obs.reset()
    assert obs.events() == []
    assert obs.metrics().counter("c").value == 0
    assert not obs.enabled()


def test_the_two_packages_keep_separate_state():
    _enable()
    obs.counter("c").inc()
    assert not ref_obs.enabled()
    assert ref_obs.snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# the disabled path is a no-op
# ---------------------------------------------------------------------------


def test_disabled_primitives_are_noops():
    assert not obs.enabled()
    s = obs.span("detect", plan="x")
    assert s is obs.NOOP_SPAN
    assert obs.span("run") is s
    with s:
        pass
    assert obs.event("k", a=1) is None
    assert obs.events() == []
    snap = obs.snapshot()
    assert snap["histograms"] == {} and snap["counters"] == {}


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_disabled_run_adds_no_telemetry_state(backend):
    """Obs off end to end: a build and five runs (and a backward) leave the
    registry, the event ring and the span log exactly empty."""
    assert not obs.enabled()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    env = _cpu_env(case)
    clear_cache()
    for _ in range(5):
        res.run(env, backend, device=CPU)
    u = env["u"].clone().requires_grad_()
    out = res.run({**env, "u": u}, backend, device=CPU)
    torch.autograd.grad(sum(v.sum() for v in out.values()), [u])
    snap = obs.snapshot()
    assert snap["counters"] == {}
    assert snap["gauges"] == {}
    assert snap["histograms"] == {}
    assert obs.events() == []
    assert obs.span_records() == []
    tel = res.telemetry()
    assert tel["obs_enabled"] is False
    assert "metrics" not in tel and "events" not in tel


def test_disabled_call_sites_are_cheap():
    """The per-call cost of a disabled instrumentation site stays in the
    sub-microsecond regime (the reference's 20us/call ceiling)."""
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        if not obs.enabled():
            pass
    t_flag = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("run", plan="x", backend="torch"):
            pass
        obs.event("k", a=1)
    t_site = (time.perf_counter() - t0) / n
    assert t_flag < 20e-6
    assert t_site < 20e-6


# ---------------------------------------------------------------------------
# integration: one structured event per pipeline decision
# ---------------------------------------------------------------------------


def _strided_program(mod, tag: str):
    """A unique (per ``tag``) 1-D program whose array is read at two
    strides: refused by the adjoint builder and by the kernel's probe in
    both packages (``mod`` gives ``arr``, ``loopnest``, ``program``)."""
    arr_, loopnest_, program_ = mod
    loops, (i,) = loopnest_(("i", 1, 16))
    u, out = arr_(f"u_{tag}"), arr_(f"o_{tag}")
    return program_(loops, [(out[i], u[2 * i] + u[i])])


PORT_IR = (arr, loopnest, program)
REF_IR = (ref_arr, ref_loopnest, ref_program)


def test_executor_cache_counters_and_events():
    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    env = _cpu_env(case)
    clear_cache()
    ph = plan_hash(res.plan)
    compile_plan(res.plan, env, "torch")  # miss
    compile_plan(res.plan, env, "torch")  # hit
    snap = obs.snapshot()
    assert snap["counters"][
        f"race_executor_cache_total{{event=miss,plan={ph}}}"] == 1
    assert snap["counters"][
        f"race_executor_cache_total{{event=hit,plan={ph}}}"] == 1
    assert snap["gauges"]["race_executor_cache_size"] == 1
    builds = obs.events(kind="executor_build")
    assert len(builds) == 1 and builds[0]["plan"] == ph
    assert builds[0]["backend"] == "torch"
    assert builds[0]["device"] == "cpu"


def test_executor_evict_event():
    _enable()
    case = get_case("gaussian", 16)
    r0 = race(case.program, reassociate=0)
    r3 = race(case.program, reassociate=3)
    env = _cpu_env(case)
    clear_cache()
    try:
        configure_cache(1)
        compile_plan(r0.plan, env, "torch")
        compile_plan(r3.plan, env, "torch")  # evicts the r0 executor
        evs = obs.events(kind="executor_evict")
        assert len(evs) == 1
        assert evs[0]["plan"] == plan_hash(r0.plan)
        assert obs.snapshot()["counters"][
            "race_executor_cache_total"
            f"{{event=evict,plan={plan_hash(r0.plan)}}}"] == 1
        configure_cache(128)
        compile_plan(r0.plan, env, "torch")
        configure_cache(1)  # shrinking evicts through the same events
        assert len(obs.events(kind="executor_evict")) == 2
    finally:
        configure_cache(128)
        clear_cache()
    assert obs.snapshot()["gauges"]["race_executor_cache_size"] == 0


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_executor_run_spans_and_counters(backend):
    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    env = _cpu_env(case)
    clear_cache()
    ex = compile_plan(res.plan, env, backend)
    for _ in range(3):
        ex(env)
    summary = obs.span_summary()
    assert summary["lower"]["count"] == 1
    assert summary["compile"]["count"] == 1  # first call only
    assert summary["run"]["count"] == 2
    ph = plan_hash(res.plan)
    assert obs.snapshot()["counters"][
        f"race_executor_runs_total{{backend={backend},plan={ph}}}"] == 3


def test_executor_batch_spans_and_counters():
    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    envs = [build_env(case, np.float32, seed=s) for s in range(3)]
    clear_cache()
    for _ in range(2):
        res.run_batch(envs, "torch", device=CPU)
    ph = plan_hash(res.plan)
    recs = [r for r in obs.span_records()
            if r["name"] in ("compile", "run")]
    assert [r["name"] for r in recs] == ["compile", "run"]
    assert all(r["labels"]["batch"] == "1" for r in recs)
    assert obs.snapshot()["counters"][
        f"race_executor_batch_runs_total{{backend=torch,plan={ph}}}"] == 2


def test_race_spans_gauges_and_telemetry():
    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    summary = obs.span_summary()
    assert summary["detect"]["count"] == 1
    assert summary["contract"]["count"] == 1
    tel = res.telemetry()
    assert tel["obs_enabled"] is True
    assert tel["plan"] == plan_hash(res.plan)
    assert 0.0 < tel["reduced_ops"] < 1.0
    gauges = tel["metrics"]["gauges"]
    assert any(s.startswith("race_reduced_ops") for s in gauges)
    assert any(s.startswith("race_aux_materialized") for s in gauges)
    for series in tel["metrics"]["counters"]:
        assert f"plan={tel['plan']}" in series or "plan=" not in series


def test_backend_fallback_event():
    _enable()
    res = race(_strided_program(PORT_IR, "bf"))
    sel = select_backend(res.plan, "auto")
    assert sel.backend == "torch"  # the probe refused the kernel
    evs = obs.events(kind="backend_fallback")
    assert len(evs) == 1
    ev = evs[0]
    assert ev["plan"] == plan_hash(res.plan)
    assert ev["requested"] == "auto" and ev["backend"] == "torch"
    assert ev["codes"] and ev["reasons"]
    assert obs.snapshot()["counters"][
        "race_backend_selections_total{backend=torch,requested=auto}"] == 1


def test_refused_hopper_request_is_emitted():
    _enable()
    res = race(_strided_program(PORT_IR, "un"))
    with pytest.raises(Exception, match="mixed-stride"):
        select_backend(res.plan, "hopper")
    (ev,) = obs.events(kind="backend_fallback")
    assert ev["backend"] == "unavailable"
    assert obs.snapshot()["counters"][
        "race_backend_selections_total{backend=unavailable,"
        "requested=hopper}"] == 1


def test_lowering_facts_event_on_eligible_plan():
    _enable()
    loops, (i,) = loopnest(("i", 2, 30))
    u, out = arr("u_lf"), arr("o_lf")
    res = race(program(loops, [(out[i], (u[i - 1] + u[i]) + u[i + 1])]),
               reassociate=3)
    sel = select_backend(res.plan, "auto")
    assert sel.backend == "hopper"
    evs = obs.events(kind="lowering_facts")
    assert evs and evs[-1]["plan"] == plan_hash(res.plan)
    assert "depth" in evs[-1]["codes"]


def test_selection_is_emitted_once_per_plan_and_request():
    """compile_plan memoizes the probe per plan and request, as the
    reference does, so runs do not repeat the selection's telemetry."""
    _enable()
    loops, (i,) = loopnest(("i", 2, 30))
    u, out = arr("u_once"), arr("o_once")
    res = race(program(loops, [(out[i], (u[i - 1] + u[i]) + u[i + 1])]),
               reassociate=3)
    env = {"u_once": np.linspace(0, 1, 32, dtype=np.float32)}
    for _ in range(3):
        res.run(env, "auto", device=CPU)
    assert len(obs.events(kind="lowering_facts")) == 1
    assert obs.snapshot()["counters"][
        "race_backend_selections_total{backend=hopper,requested=auto}"] == 1


def test_adjoint_refusal_event():
    _enable()
    prog = _strided_program(PORT_IR, "adj")
    build = adjoint_build(prog)
    assert not build.ok
    evs = obs.events(kind="adjoint_refusal")
    assert len(evs) == 1
    assert evs[0]["reason"] and evs[0]["reason"] in build.reason
    assert obs.snapshot()["counters"][
        "race_adjoint_builds_total{outcome=refused}"] == 1


def test_adjoint_build_and_backward_telemetry(monkeypatch):
    monkeypatch.setattr(port_adjoint, "_builds", {})  # a build to record
    _enable()
    case = get_case("smooth1d", 24)
    res = race(case.program, reassociate=case.reassociate)
    env = _cpu_env(case, np.float64)
    name = next(k for k, v in env.items() if v.dim() == 1
                and k not in {st.lhs.name for st in case.program.body})
    x = env[name].clone().requires_grad_()

    def grad():
        out = res.run({**env, name: x}, "torch", device=CPU)
        return torch.autograd.grad(sum(v.sum() for v in out.values()), [x])

    grad()
    grad()  # the build is memoized: one build, two backward calls
    monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    grad()
    snap = obs.snapshot()["counters"]
    assert snap["race_adjoint_builds_total{outcome=supported}"] == 1
    assert snap["race_adjoint_backward_total{mode=stencil}"] == 2
    assert snap["race_adjoint_backward_total{mode=autodiff-forced}"] == 1
    summary = obs.span_summary()
    assert summary["adjoint_build"]["count"] == 1
    assert summary["adjoint_backward"]["count"] == 2


def test_frontend_diagnostic_event():
    _enable()

    def bad(u, out):
        n, m = u.shape
        for i in range(1, n):
            for j in range(1, m):
                if j > 2:  # control flow: refused with D_CONTROL_FLOW
                    out[i, j] = u[i, j]

    with pytest.raises(CaptureError):
        capture(bad, {"u": (8, 8), "out": (8, 8)})
    evs = obs.events(kind="frontend_diagnostic")
    assert len(evs) == 1
    assert evs[0]["code"] == D_CONTROL_FLOW
    assert evs[0]["function"] == "bad"
    assert obs.snapshot()["counters"][
        f"race_frontend_diagnostics_total{{code={D_CONTROL_FLOW}}}"] == 1


def test_frontend_capture_success_counts():
    _enable()

    def ok(u, out):
        n, m = u.shape
        for i in range(1, n - 1):
            for j in range(1, m - 1):
                out[i, j] = u[i - 1, j] + u[i + 1, j]

    capture(ok, {"u": (8, 8), "out": (8, 8)})
    assert obs.snapshot()["counters"]["race_frontend_captures_total"] == 1
    assert obs.span_summary()["capture"]["count"] == 1



@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_tuning_gate_event(backend):
    from repro_torch.tuning.measure import measure_candidate
    from repro_torch.tuning.space import Config

    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=0)
    env = _cpu_env(case)
    truth = {k: v.numpy() + 1e3  # deliberately wrong baseline
             for k, v in compile_plan(res.plan, env, "torch")(env).items()}
    m = measure_candidate(res.plan, Config(0, backend), env, truth, 1e-6)
    assert m.status == "gated"
    evs = obs.events(kind="tuning_gate")
    assert len(evs) == 1
    assert evs[0]["status"] == "gated"
    assert evs[0]["plan"] == plan_hash(res.plan)
    assert evs[0]["config"] == Config(0, backend).describe()
    snap = obs.snapshot()
    assert snap["counters"][
        "race_tuning_candidates_total{status=gated}"] == 1


# ---------------------------------------------------------------------------
# dump + report CLI
# ---------------------------------------------------------------------------


def test_dump_and_report_roundtrip(tmp_path, capsys):
    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    env = _cpu_env(case)
    clear_cache()
    res.run(env, "torch", device=CPU)
    path = tmp_path / "dump.json"
    doc = obs.dump(path)
    assert doc["stamp"]["schema"] == obs.OBS_SCHEMA
    assert "T" in doc["stamp"]["ts"]
    on_disk = json.loads(path.read_text())
    assert on_disk["metrics"]["counters"] == doc["metrics"]["counters"]

    rc = report.main([str(path), "--require-spans", "detect,lower,compile"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "require-spans ok" in out
    assert "detect" in out
    assert "torch=" in out  # the stamp line names the port's versions

    rc = report.main([str(path), "--require-spans", "no_such_span"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "MISSING SPANS: no_such_span" in err


def test_report_span_table_merges_label_sets():
    metrics = {"histograms": {
        "race_span_seconds{path=run,span=run}": dict(
            count=2, sum=0.2, edges=[0.1, 1.0], counts=[1, 1, 0], max=0.5),
        "race_span_seconds{path=a/run,span=run}": dict(
            count=1, sum=0.05, edges=[0.1, 1.0], counts=[1, 0, 0], max=0.05),
    }}
    table = report.span_table(metrics)
    assert table["run"]["count"] == 3
    assert table["run"]["total"] == pytest.approx(0.25)
    assert table["run"]["p95"] == pytest.approx(1.0)


def test_run_stamp_fields():
    st = obs.run_stamp()
    assert st["schema"] == obs.OBS_SCHEMA
    assert st["ts"].endswith("+00:00")
    assert "jax" not in st
    assert st["torch"] == torch.__version__
    assert st["cuda"] == torch.version.cuda
    # no card here: the device names the host's processor
    assert st["device"].startswith("cpu:") and len(st["device"]) > 4
    assert isinstance(st["host_cpu_count"], int) and st["host_cpu_count"] >= 1
    assert st["host"]


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _series(o) -> set:
    """``(kind, name, label keys)`` of every registry series."""
    reg = o.metrics()
    out = set()
    for kind, table in (("counter", reg._counters), ("gauge", reg._gauges),
                        ("histogram", reg._histograms)):
        for (name, labels), _ in reg._items(table):
            out.add((kind, name, tuple(k for k, _ in labels)))
    return out


def _ref_sequence(name: str) -> dict:
    case = ref_get_case(name, SWEEP_SIZES[name])
    res = ref_race(case.program, reassociate=case.reassociate,
                   rewrite_div=case.rewrite_div)
    env = ref_build_env(case, np.float32)
    ref_clear_cache()
    ex = ref_compile_plan(res.plan, env, "xla")
    outs = [ex(env) for _ in range(3)]
    jax.block_until_ready(outs)
    ref_adjoint_build(_strided_program(REF_IR, f"par_{name}"))
    ref_select_backend(ref_race(_strided_program(REF_IR, f"pf_{name}")).plan,
                       "auto")
    return res.telemetry()


def _port_sequence(name: str) -> dict:
    case = get_case(name, SWEEP_SIZES[name])
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    env = _cpu_env(case)
    clear_cache()
    ex = compile_plan(res.plan, env, "torch")
    for _ in range(3):
        ex(env)
    adjoint_build(_strided_program(PORT_IR, f"par_{name}"))
    select_backend(race(_strided_program(PORT_IR, f"pf_{name}")).plan,
                   "auto")
    return res.telemetry()


@pytest.mark.parametrize("name", ["gaussian", "j3d27pt", "smooth1d"])
def test_same_calls_give_the_reference_telemetry(name):
    """race, compile_plan and 3 runs ("xla" there, "torch" here), a refused
    adjoint and a fallback, with obs on in both packages: the same metric
    names and label keys, event kinds, span names and telemetry keys and
    identities."""
    ref_obs.configure(enabled=True)
    _enable()
    want = _ref_sequence(name)
    got = _port_sequence(name)
    assert _series(obs) == _series(ref_obs)
    assert ({e["kind"] for e in obs.events()}
            == {e["kind"] for e in ref_obs.events()})
    assert set(obs.span_summary()) == set(ref_obs.span_summary())
    assert set(got) == set(want)
    case = get_case(name, SWEEP_SIZES[name])
    if (name, case.reassociate) in SEED_DEPENDENT_PLANS:
        # the reference's plan follows PYTHONHASHSEED here (ROADMAP F7):
        # the port's is the reference's under seed 0
        (rec,) = reference_under_seed0([("plan", name, SWEEP_SIZES[name],
                                         case.reassociate)]).values()
        want = dict(want, **rec["telemetry"])
    for key in PLAN_KEYS:
        assert got[key] == want[key], key
    assert set(got["metrics"]) == set(want["metrics"])
    assert ({s["name"] for s in got["spans"]}
            == {s["name"] for s in want["spans"]})


@pytest.mark.parametrize("name", ["gaussian", "j3d27pt", "smooth1d"])
def test_gradient_gives_the_reference_series(name, monkeypatch):
    """A gradient through ``run`` (``jax.grad`` there, ``autograd.grad``
    here) with obs on: the same metric names and label keys and span names,
    adjoint series included.  Counts differ by design: the reference's
    backward runs under jit and computes every input's gradient, the port's
    is eager and computes only those asked for (ROADMAP Queue 3, F2 and
    F5).  Event kinds are not compared: the port's probe admits adjoint
    plans that the reference sends to ``"xla"`` with a fallback event."""
    # fresh adjoint memos, so both builds run (and record) here
    monkeypatch.setattr(ref_adjoint, "_builds", {})
    monkeypatch.setattr(port_adjoint, "_builds", {})
    ref_obs.configure(enabled=True)
    _enable()
    case = ref_get_case(name, SWEEP_SIZES[name])
    res = ref_race(case.program, reassociate=case.reassociate)
    env = ref_build_env(case, np.float32)
    outs = {st.lhs.name for st in case.program.body}
    keys = [k for k in env if k not in outs and np.ndim(env[k]) > 0]
    grads = jax.grad(lambda p: sum(
        v.sum() for v in res.run({**env, **p}, "xla").values()))(
        {k: env[k] for k in keys})
    jax.block_until_ready(grads)

    pcase = get_case(name, SWEEP_SIZES[name])
    pres = race(pcase.program, reassociate=pcase.reassociate)
    penv = _cpu_env(pcase)
    leaves = {k: penv[k].clone().requires_grad_() for k in keys}
    out = pres.run({**penv, **leaves}, "torch", device=CPU)
    torch.autograd.grad(sum(v.sum() for v in out.values()),
                        list(leaves.values()))
    # the port's own metrics (obs.PORT_METRICS) have no counterpart there
    assert {x for x in _series(obs)
            if x[1] not in obs.PORT_METRICS} == _series(ref_obs)
    # the port's own spans (obs.PORT_SPANS) have no counterpart there
    port, ref = set(obs.span_summary()), set(ref_obs.span_summary())
    assert port - set(obs.PORT_SPANS) == ref
    assert port - ref <= set(obs.PORT_SPANS)
    assert {"adjoint_build", "adjoint_backward"} <= set(obs.span_summary())
    assert ("counter", "race_adjoint_backward_total", ("mode",)) in \
        _series(obs)
