"""The port's perf-regression sentinel: history store, gate, Chrome trace.

The history, check, report and trace cases of ``tests/test_sentinel.py``
on the port's own copies (``repro_torch.obs.{history,check,report,
trace}``), plus the port's own key: its rows carry ``torch=`` and
``cuda=`` where the reference's carry ``jax=``, so a row of one package
never joins a baseline of the other, even in one history file.

``tests/conftest.py`` isolates only the reference's obs state, so this
file resets the port's around every test.
"""
import json

import pytest
pytest.importorskip("torch")

from repro.obs import history as ref_history
from repro_torch import obs
from repro_torch.obs import check, report
from repro_torch.obs.history import (BenchHistory, append_rows, case_key,
                                     env_key, make_records, row_metrics)
from repro_torch.obs.trace import chrome_trace

pytestmark = [pytest.mark.port, pytest.mark.obs]

STAMP = {"schema": 1, "device": "cpu:TestCpu", "torch": "0.0.test",
         "cuda": "0.0", "host_cpu_count": 1, "host": "test-host"}


@pytest.fixture(autouse=True)
def _isolated_port_obs(monkeypatch):
    for knob in (obs.ENV_OBS, obs.ENV_EVENTS, obs.ENV_RING, obs.ENV_SPANS):
        monkeypatch.delenv(knob, raising=False)
    obs.reset()
    yield
    obs.reset()


def _stamp(ts):
    return dict(STAMP, ts=ts)


def _serving_row(us, case="gaussian", **extra):
    return dict(case=case, backend="xla", us_per_call=us, cold_ms=400.0,
                hit_rate=1.0, **extra)


def _seed_history(path, values, case="gaussian", section="serving"):
    h = BenchHistory(path)
    for i, us in enumerate(values):
        h.append(make_records(
            section, [_serving_row(us, case=case)],
            _stamp(f"2026-08-{i + 1:02d}T00:00:00+00:00"), sha=f"sha{i}"))
    return h


def _bench_doc(tmp_path, rows, section="serving",
               ts="2026-08-09T00:00:00+00:00"):
    doc = dict(stamp=_stamp(ts), section=section, rows=rows)
    p = tmp_path / f"BENCH_{section}.json"
    p.write_text(json.dumps(doc))
    return p, doc


# ---------------------------------------------------------------------------
# history store
# ---------------------------------------------------------------------------


def test_history_keys_and_metrics():
    stamp = _stamp("2026-08-01T00:00:00+00:00")
    assert env_key(stamp) == "cpu:TestCpu|torch=0.0.test|cuda=0.0|cores=1"
    row = _serving_row(123.0, n=64)
    # identity fields key the series; numeric non-identity fields measure it
    assert case_key(row) == "backend=xla;case=gaussian;n=64"
    m = row_metrics(row)
    assert m["us_per_call"] == 123.0 and "case" not in m and "n" not in m
    # bools, NaNs, and nested structures never become metrics
    assert "ok" not in row_metrics(dict(ok=True, cfg={"a": 1}, xs=[1]))
    recs = make_records("serving", [row], stamp, sha="abc")
    assert len(recs) == 1
    r = recs[0]
    assert (r["section"], r["sha"], r["ts"]) == (
        "serving", "abc", stamp["ts"])
    assert r["env"] == env_key(stamp)


def test_history_append_reload_and_baseline(tmp_path):
    path = tmp_path / "h.jsonl"
    h = _seed_history(path, [100.0, 101.0, 102.0])
    # a second handle sees the same records (mtime-checked reload)
    h2 = BenchHistory(path)
    assert len(h2) == 3
    base = h2.baseline("serving", case_key(_serving_row(0)),
                       env_key(STAMP))
    assert [r["metrics"]["us_per_call"] for r in base] == [100.0, 101.0,
                                                           102.0]
    # the current run's own just-appended record is excluded by its ts
    h2.append(make_records("serving", [_serving_row(999.0)],
                           _stamp("2026-08-09T00:00:00+00:00")))
    base = h2.baseline("serving", case_key(_serving_row(0)),
                       env_key(STAMP),
                       exclude_ts="2026-08-09T00:00:00+00:00")
    assert len(base) == 3
    # a different environment has an empty baseline
    other = env_key(dict(STAMP, host_cpu_count=96))
    assert h2.baseline("serving", case_key(_serving_row(0)), other) == []


def test_history_corruption_and_foreign_schema(tmp_path):
    path = tmp_path / "h.jsonl"
    h = _seed_history(path, [100.0, 101.0])
    with open(path, "a") as f:
        f.write("{truncated-not-json\n")
        f.write(json.dumps({"schema": 99, "key": "future-version"}) + "\n")
        f.write("\n")
    h2 = BenchHistory(path)
    assert len(h2) == 2  # corrupt + foreign lines invisible, load survives
    h2.append(make_records("serving", [_serving_row(102.0)],
                           _stamp("2026-08-03T00:00:00+00:00")))
    text = path.read_text()
    assert "future-version" in text  # foreign schema survives the rewrite
    assert "truncated" not in text  # truly malformed lines stay dropped


def test_history_compaction_keeps_newest_per_series(tmp_path):
    path = tmp_path / "h.jsonl"
    h = _seed_history(path, [float(100 + i) for i in range(6)])
    _seed_history(path, [50.0, 51.0], case="psinv")
    dropped = h.compact(keep=2)
    assert dropped == 4  # only the 6-long gaussian series lost records
    base = h.baseline("serving", case_key(_serving_row(0)), env_key(STAMP))
    assert [r["metrics"]["us_per_call"] for r in base] == [104.0, 105.0]
    base = h.baseline("serving", case_key(_serving_row(0, case="psinv")),
                      env_key(STAMP))
    assert len(base) == 2  # untouched series keeps everything


def test_history_missing_file_and_unset_env(tmp_path, monkeypatch):
    h = BenchHistory(tmp_path / "never-written.jsonl")
    assert h.records() == [] and h.compact() == 0
    assert not (tmp_path / "never-written.jsonl").exists()  # no fabrication
    # append_rows is a no-op without $RACE_BENCH_HISTORY (conftest clears it)
    assert append_rows("serving", [_serving_row(1.0)], _stamp("t")) == 0
    monkeypatch.setenv("RACE_BENCH_HISTORY", str(tmp_path / "dir"))
    n = append_rows("serving", [_serving_row(1.0)],
                    _stamp("2026-08-01T00:00:00+00:00"))
    assert n == 1
    assert (tmp_path / "dir" / "bench-history.jsonl").exists()


def test_history_speedup_nested_rows(tmp_path, monkeypatch):
    """The speedup section's ``{"cases": [...], "envelope": ...}`` rows
    shape flattens to per-case records on both the append and check side."""
    monkeypatch.setenv("RACE_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    rows = {"cases": [dict(name="calc_tpoints", t_base=1e-3,
                           speedup_RACE=3.5)],
            "envelope": dict(name="envelope", eligible=19, total=19)}
    assert append_rows("speedup", rows,
                       _stamp("2026-08-01T00:00:00+00:00")) == 1
    h = BenchHistory(tmp_path / "h.jsonl")
    assert h.records()[0]["case"] == "name=calc_tpoints"


# ---------------------------------------------------------------------------
# the regression gate
# ---------------------------------------------------------------------------


def test_metric_directions():
    assert check.metric_direction("us_per_call") == "lower"
    assert check.metric_direction("cold_ms") == "lower"
    assert check.metric_direction("t_base") == "lower"
    assert check.metric_direction("decode_s") == "lower"
    assert check.metric_direction("speedup_RACE") == "higher"
    assert check.metric_direction("hit_rate") == "higher"
    assert check.metric_direction("decode_tok_s") == "higher"
    assert check.metric_direction("batch_ips") == "higher"
    assert check.metric_direction("cache_entries") is None  # no direction
    assert check.metric_direction("devices") is None


def test_gate_trips_on_2x_serving_slowdown(tmp_path, capsys):
    """The acceptance scenario: >= 2x median slowdown on a serving row ->
    exit nonzero with a verdict naming the (section, case, metric)."""
    hist = tmp_path / "h.jsonl"
    _seed_history(hist, [100.0, 101.0, 99.0, 102.0])
    bench, _ = _bench_doc(tmp_path, [_serving_row(250.0)])
    out = tmp_path / "BENCH_verdicts.json"
    rc = check.main([str(bench), "--history", str(hist),
                     "--gate", "serving", "--out", str(out)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "REGRESSION" in err and "us_per_call" in err
    doc = json.loads(out.read_text())
    regs = [v for v in doc["verdicts"] if v["status"] == "regression"]
    assert len(regs) == 1
    v = regs[0]
    assert v["section"] == "serving"
    assert v["case"] == "backend=xla;case=gaussian"
    assert v["metric"] == "us_per_call"
    assert v["ratio"] == pytest.approx(250.0 / 100.5, rel=1e-6)
    assert v["baseline_n"] == 4
    assert doc["summary"]["regression"] == 1


def test_gate_passes_noise_within_threshold(tmp_path):
    hist = tmp_path / "h.jsonl"
    _seed_history(hist, [100.0, 101.0, 99.0, 102.0])
    bench, _ = _bench_doc(tmp_path, [_serving_row(110.0)])
    out = tmp_path / "v.json"
    rc = check.main([str(bench), "--history", str(hist),
                     "--gate", "serving", "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["summary"] == {"ok": 3}


def test_min_sample_guard_never_gates_thin_history(tmp_path):
    hist = tmp_path / "h.jsonl"
    _seed_history(hist, [100.0, 101.0])  # < default min of 3
    bench, _ = _bench_doc(tmp_path, [_serving_row(900.0)])
    out = tmp_path / "v.json"
    rc = check.main([str(bench), "--history", str(hist), "--gate",
                     "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert all(v["status"] == "insufficient-samples"
               for v in doc["verdicts"])
    # but an explicit --min-samples 2 arms the gate
    rc = check.main([str(bench), "--history", str(hist), "--gate",
                     "--min-samples", "2", "--out", str(out)])
    assert rc == 1


def test_higher_better_metric_regresses_on_drop(tmp_path):
    hist = BenchHistory(tmp_path / "h.jsonl")
    for i in range(3):
        hist.append(make_records(
            "speedup", [dict(name="calc_tpoints", speedup_RACE=4.0)],
            _stamp(f"2026-08-0{i + 1}T00:00:00+00:00")))
    bench, _ = _bench_doc(tmp_path,
                          [dict(name="calc_tpoints", speedup_RACE=1.1)],
                          section="speedup")
    rc = check.main([str(bench), "--history", str(tmp_path / "h.jsonl"),
                     "--gate", "speedup", "--out", str(tmp_path / "v.json")])
    assert rc == 1
    doc = json.loads((tmp_path / "v.json").read_text())
    assert doc["verdicts"][0]["metric"] == "speedup_RACE"
    assert doc["verdicts"][0]["status"] == "regression"


def test_ungated_sections_report_but_never_fail(tmp_path):
    hist = tmp_path / "h.jsonl"
    _seed_history(hist, [100.0] * 4, section="tuning")
    bench, _ = _bench_doc(tmp_path, [_serving_row(900.0)],
                          section="tuning")
    out = tmp_path / "v.json"
    # regression confirmed in 'tuning', but gating is scoped to 'serving'
    rc = check.main([str(bench), "--history", str(hist),
                     "--gate", "serving", "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["summary"]["regression"] >= 1  # the verdict still exists


def test_no_history_is_explicit_and_exits_zero(tmp_path, capsys):
    bench, _ = _bench_doc(tmp_path, [_serving_row(100.0)])
    rc = check.main([str(bench), "--gate",
                     "--out", str(tmp_path / "v.json")])
    assert rc == 0
    doc = json.loads((tmp_path / "v.json").read_text())
    assert all(v["status"] == "no-history" for v in doc["verdicts"])
    assert doc["history"] is None


def test_check_rejects_non_bench_input(tmp_path, capsys):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"not": "a bench doc"}))
    assert check.main([str(p), "--out", str(tmp_path / "v.json")]) == 2


def test_improvement_verdict(tmp_path):
    hist = tmp_path / "h.jsonl"
    _seed_history(hist, [100.0] * 4)
    bench, _ = _bench_doc(tmp_path, [_serving_row(40.0)])
    rc = check.main([str(bench), "--history", str(hist), "--gate",
                     "--out", str(tmp_path / "v.json")])
    assert rc == 0  # improvements never gate
    doc = json.loads((tmp_path / "v.json").read_text())
    by_metric = {v["metric"]: v for v in doc["verdicts"]}
    assert by_metric["us_per_call"]["status"] == "improved"


# ---------------------------------------------------------------------------
# span timeline + Chrome-trace export
# ---------------------------------------------------------------------------


def _enable(**kw):
    obs.configure(enabled=True, **kw)


def test_span_records_nest_on_shared_time_axis():
    _enable()
    with obs.span("race"):
        with obs.span("detect"):
            pass
        with obs.span("lower", plan="ab12", backend="xla"):
            pass
    recs = obs.span_records()
    assert [r["name"] for r in recs] == ["detect", "lower", "race"]
    by = {r["name"]: r for r in recs}
    assert by["detect"]["path"] == "race/detect"
    assert by["lower"]["labels"] == {"plan": "ab12", "backend": "xla"}
    # children are contained in the parent on the shared ts axis
    for child in ("detect", "lower"):
        c, p = by[child], by["race"]
        assert p["ts_us"] <= c["ts_us"]
        assert c["ts_us"] + c["dur_us"] <= p["ts_us"] + p["dur_us"] + 1e-3
    assert all(r["tid"] == recs[0]["tid"] for r in recs)


def test_span_log_disabled_records_nothing():
    assert not obs.enabled()
    with obs.span("race"):
        pass
    assert obs.span_records() == []


def test_span_log_is_bounded(monkeypatch):
    monkeypatch.setenv(obs.ENV_SPANS, "4")
    monkeypatch.setenv(obs.ENV_OBS, "1")
    obs.reset()
    for i in range(10):
        with obs.span(f"s{i}"):
            pass
    recs = obs.span_records()
    assert [r["name"] for r in recs] == ["s6", "s7", "s8", "s9"]
    assert obs.span_log().dropped == 6


def test_chrome_trace_structure_and_tolerance():
    recs = [
        dict(name="race", path="race", ts_us=0.0, dur_us=100.0, tid=7,
             thread="MainThread", labels={}),
        dict(name="detect", path="race/detect", ts_us=10.0, dur_us=20.0,
             tid=7, thread="MainThread", labels={"plan": "ab"}),
        {"corrupt": "record"},  # skipped, never fatal
    ]
    doc = chrome_trace(recs, stamp=STAMP, origin_epoch=123.0)
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["race", "detect"]  # ts-sorted
    assert all(e["pid"] == 1 and e["tid"] == 7 for e in xs)
    assert xs[1]["args"] == {"path": "race/detect", "plan": "ab"}
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "thread_name"
               and e["args"]["name"] == "MainThread" for e in meta)
    assert doc["otherData"]["span_origin_epoch"] == 123.0
    assert doc["otherData"]["device"] == STAMP["device"]
    json.dumps(doc)  # loadable = serializable


def test_pipeline_trace_reconstructs_phase_hierarchy(tmp_path, capsys):
    """A real detect -> lower -> compile -> run pipeline dumped and
    exported via ``report --trace-out`` yields valid Chrome trace JSON
    whose span events carry the nesting paths."""
    from repro_torch.apps.paper_kernels import get_case
    from repro_torch.core.executor import clear_cache
    from repro_torch.core.race import race
    from repro_torch.testing import build_env

    _enable()
    case = get_case("gaussian", 16)
    res = race(case.program, reassociate=case.reassociate)
    clear_cache()
    env = build_env(case)
    res.run(env, "hopper", device="cpu")  # cold: lower + compile spans
    res.run(env, "hopper", device="cpu")  # steady: run span
    dump = tmp_path / "dump.json"
    obs.dump(dump)
    trace = tmp_path / "trace.json"
    rc = report.main([str(dump), "--trace-out", str(trace)])
    assert rc == 0
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(trace.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"detect", "lower", "compile", "run"} <= names
    # every event's path terminates in its own leaf name (hierarchy intact)
    for e in xs:
        assert e["args"]["path"].split("/")[-1] == e["name"]
        assert e["dur"] >= 0.0
    # executor events carry the plan-hash label for click-through
    lower = next(e for e in xs if e["name"] == "lower")
    assert lower["args"]["plan"]
    # telemetry() scopes the same records to one plan
    tel = res.telemetry()
    assert tel["spans"] and all(
        s["labels"]["plan"] == tel["plan"] for s in tel["spans"])


def test_report_trace_out_without_spans_exits_2(tmp_path, capsys):
    dump = tmp_path / "d.json"
    dump.write_text(json.dumps({"metrics": {}, "events": []}))
    rc = report.main([str(dump), "--trace-out", str(tmp_path / "t.json")])
    assert rc == 2
    assert "NO SPAN RECORDS" in capsys.readouterr().err
    assert not (tmp_path / "t.json").exists()


def test_require_spans_failure_prints_timing_context(tmp_path, capsys):
    _enable()
    with obs.span("detect"):
        pass
    dump = tmp_path / "d.json"
    obs.dump(dump)
    rc = report.main([str(dump), "--require-spans", "lower"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "MISSING SPANS: lower" in err
    assert "recorded spans" in err and "detect" in err and "p95" in err


def test_port_and_reference_rows_never_share_a_baseline(tmp_path):
    """A JAX-stamped row and a port-stamped row in one history file, on the
    same device string, host and series: each package's baseline holds its
    own rows only."""
    path = tmp_path / "h.jsonl"
    row = _serving_row(100.0)
    ref_stamp = {"schema": 1, "device": "cpu:TestCpu", "jax": "0.0.test",
                 "host_cpu_count": 1, "host": "test-host",
                 "ts": "2026-08-01T00:00:00+00:00"}
    ref_history.BenchHistory(path).append(
        ref_history.make_records("serving", [row], ref_stamp, sha="ref"))
    h = BenchHistory(path)
    h.append(make_records("serving", [_serving_row(50.0)],
                          _stamp("2026-08-02T00:00:00+00:00"), sha="port"))
    assert len(h) == 2
    assert env_key(STAMP) != ref_history.env_key(ref_stamp)
    # neither package's key for the other's stamp names its own rows
    assert env_key(ref_stamp) != ref_history.env_key(ref_stamp)
    assert ref_history.env_key(STAMP) != env_key(STAMP)
    port_base = h.baseline("serving", case_key(row), env_key(STAMP))
    assert [r["sha"] for r in port_base] == ["port"]
    ref_base = ref_history.BenchHistory(path).baseline(
        "serving", ref_history.case_key(row), ref_history.env_key(ref_stamp))
    assert [r["sha"] for r in ref_base] == ["ref"]
    assert h.baseline("serving", case_key(row), env_key(ref_stamp)) == []


def test_port_run_stamp_keys_its_own_series(tmp_path, monkeypatch):
    """append_rows with the live stamp files the row under the port's key:
    ``torch=`` and ``cuda=``, never ``jax=``."""
    monkeypatch.setenv("RACE_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    stamp = obs.run_stamp()
    assert append_rows("serving", [_serving_row(1.0)], stamp) == 1
    (rec,) = BenchHistory(tmp_path / "h.jsonl").records()
    assert rec["env"] == env_key(stamp)
    assert "|torch=" in rec["env"] and "|cuda=" in rec["env"]
    assert "jax=" not in rec["env"]
