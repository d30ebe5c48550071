"""The port's autotuner, ``repro_torch.tuning``, against the reference's
``repro.tuning``.

The 36 tests of ``tests/test_tuning.py`` on the port (CPU: ``device="cpu"``,
where ``"hopper"`` is K1's tile emulator), each under its reference name,
plus parity with the reference tuner on the same inputs: its plans per
reassociation level, the gate on a candidate forced to be wrong, the tie
rule, and one store file written by both packages.

Where a reference test does not carry over as it stands:

  * its ``"xla"`` backend is the port's ``"torch"``, its ``"pallas"`` the
    port's ``"hopper"``; block fields default to 0 (the chooser's tile);
  * ``SCHEMA_VERSION`` is the tag ``"torch-1"``, so the other-schema lines
    are other tags (and the reference's integer schema);
  * ``test_run_batch_traceable_under_jit_and_grad`` pinned a jit/grad
    tracer bug of ``run_batch``; the port has no tracing, so it holds the
    same contract on ``torch.autograd``: a stacked batch that requires grad
    runs (with a tune option set), and its gradient is finite;
  * the stored-block tests read K1's geometry (``ex.spec.tp.geometry``)
    where the reference read ``ex.block_rows``.

``tests/conftest.py`` gives every test its own ``$RACE_TUNING_CACHE``,
which both packages read.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_get_case
from repro.core.executor import executor_cache as ref_executor_cache
from repro.testing.differential import build_env as ref_build_env
from repro.tuning import autotune as ref_autotune
from repro.tuning import default_store as ref_default_store
from repro.tuning import measure as ref_measure
from repro.tuning import store as ref_store
from repro_torch.apps.paper_kernels import get_case
from repro_torch.core.executor import (ExecutorCache, compile_plan,
                                       default_backend, env_signature,
                                       env_to_torch, executor_cache,
                                       plan_hash, program_hash)
from repro_torch.core.ir import Scalar, arr, loopnest, mul, program
from repro_torch.core.race import race
from repro_torch.testing.differential import (build_env, default_tolerances,
                                              rel_err, run_case)
from repro_torch.tuning import (SCHEMA_VERSION, TuningStore, autotune,
                                default_store, record_key, runtime_fence,
                                store_file)
from repro_torch.tuning import measure as port_measure

pytestmark = [pytest.mark.port, pytest.mark.tuning]

SRC = str(Path(__file__).resolve().parent.parent / "src")
CPU = "cpu"
OTHER_SCHEMA = "torch-2"


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor_cache().clear()
    yield
    executor_cache().clear()


def _case(name="gaussian", n=12):
    return get_case(name, n)


def _tenv(case, dtype=np.float32):
    return env_to_torch(build_env(case, dtype), CPU)


def _rec(key, choice=None):
    return dict(key=key, kind="plan", hash="h", device="cpu", torch="x",
                cuda=None,
                choice=choice or dict(reassociate=0, backend="torch",
                                      block_rows=0, block_cols=0,
                                      block_inner=0))


QUICK = dict(levels=(0, 3), backends=("torch",), repeats=2, warmup=1)


# ---------------------------------------------------------------------------
# the persistent store
# ---------------------------------------------------------------------------


def test_store_roundtrip_across_instances(tmp_path):
    path = tmp_path / "t.jsonl"
    s1 = TuningStore(path)
    s1.put(_rec("a"))
    s1.put(_rec("b"))
    s2 = TuningStore(path)  # a fresh instance sees both records
    assert s2.get("a")["choice"]["backend"] == "torch"
    assert sorted(s2.keys()) == ["a", "b"]
    # every on-disk line is complete, schema-stamped JSON (atomic writes)
    for line in path.read_text().splitlines():
        assert json.loads(line)["schema"] == SCHEMA_VERSION


def test_put_overwrites_by_key(tmp_path):
    s = TuningStore(tmp_path / "t.jsonl")
    s.put(_rec("a"))
    s.put(_rec("a", choice=dict(reassociate=3, backend="torch")))
    assert len(s) == 1
    assert s.get("a")["choice"]["reassociate"] == 3


def test_corrupt_store_degrades_never_crashes(tmp_path):
    path = tmp_path / "t.jsonl"
    good = json.dumps(dict(_rec("good"), schema=SCHEMA_VERSION))
    path.write_text("not json at all\n" + good + "\n"
                    + good[: len(good) // 2])  # truncated mid-record
    s = TuningStore(path)
    assert s.get("good") is not None  # the intact record still loads
    assert len(s) == 1
    s.put(_rec("new"))  # writing through corruption works...
    s2 = TuningStore(path)
    assert sorted(s2.keys()) == ["good", "new"]
    for line in path.read_text().splitlines():  # ...and scrubs the file
        json.loads(line)


def test_binary_garbage_store_is_empty_not_fatal(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_bytes(b"\x00\xff\xfe garbage \x00" * 10)
    assert TuningStore(path).get("anything") is None


def test_schema_version_mismatch_ignored(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps(dict(_rec("old"), schema=OTHER_SCHEMA))
                    + "\n")
    s = TuningStore(path)
    assert s.get("old") is None  # future/old schema: re-tune, don't guess
    s.put(_rec("cur"))
    assert TuningStore(path).get("cur") is not None


def test_concurrent_writers_lose_no_records(tmp_path):
    path = tmp_path / "t.jsonl"
    errors = []

    def writer(wid):
        try:
            s = TuningStore(path)  # own instance == own fd == real contention
            for i in range(5):
                s.put(_rec(f"w{wid}-{i}"))
        except Exception as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    final = TuningStore(path)
    assert len(final) == 40  # read-merge-replace under flock: nothing lost


def test_compact_keeps_newest_record_per_key(tmp_path):
    """An append-mode history (duplicate keys, stale schemas) compacts down
    to one line per live key, newest winning, under the atomic rewrite."""
    path = tmp_path / "t.jsonl"
    lines = []
    for gen in range(5):
        for k in range(4):
            lines.append(json.dumps(dict(
                schema=SCHEMA_VERSION, key=f"k{k}", gen=gen)))
    lines.append(json.dumps(dict(schema=OTHER_SCHEMA, key="old")))
    lines.append("not json at all")
    path.write_text("\n".join(lines) + "\n")
    store = TuningStore(path)
    assert len(store) == 4  # live view already dedups (last line wins)
    removed = store.compact()
    # the other-schema record survives the rewrite (only dup/garbage lines
    # are reclaimed): 22 lines -> 4 live + 1 foreign
    assert removed == 22 - 4 - 1
    on_disk = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(on_disk) == 5
    assert {r["key"]: r["gen"] for r in on_disk
            if r["schema"] == SCHEMA_VERSION} == {
        f"k{k}": 4 for k in range(4)}
    assert any(r["schema"] == OTHER_SCHEMA and r["key"] == "old"
               for r in on_disk)
    # still a fully valid store afterwards
    assert TuningStore(path).get("k2")["gen"] == 4


def test_compact_auto_triggers_past_line_threshold(tmp_path):
    path = tmp_path / "t.jsonl"
    lines = [json.dumps(dict(schema=SCHEMA_VERSION, key=f"k{i % 3}", i=i))
             for i in range(40)]
    path.write_text("\n".join(lines) + "\n")
    store = TuningStore(path, compact_threshold=10)
    assert store.get("k0") is not None  # any read triggers the reload
    assert len(path.read_text().splitlines()) == 3  # rewritten compacted
    # below the threshold nothing rewrites (no gratuitous churn)
    small = tmp_path / "s.jsonl"
    small.write_text("\n".join(lines[:6]) + "\n")
    s2 = TuningStore(small, compact_threshold=10)
    assert s2.get("k1") is not None
    assert len(small.read_text().splitlines()) == 6


def test_compact_empty_and_missing_store(tmp_path):
    path = tmp_path / "missing.jsonl"
    store = TuningStore(path)
    assert store.compact() == 0  # no file: a no-op, never a crash
    assert not path.exists()  # ...and nothing fabricated on disk
    store.put(_rec("a"))
    mtime = path.stat().st_mtime_ns
    assert store.compact() == 0  # already compact: no gratuitous rewrite
    assert path.stat().st_mtime_ns == mtime


def test_compact_evicts_by_age(tmp_path, monkeypatch):
    """Records older than RACE_TUNING_MAX_AGE_DAYS (by their ``ts`` write
    stamp) are dropped during compact; fresh ones and foreign-schema lines
    survive the rewrite verbatim."""
    import time as _time

    from repro_torch.tuning.store import eviction_limits

    now = _time.time()
    path = tmp_path / "t.jsonl"
    store = TuningStore(path)
    store.put(dict(_rec("fresh"), ts=now - 3600.0))
    store.put(dict(_rec("stale"), ts=now - 40 * 86400.0))
    store.put(dict(_rec("unstamped")))  # put() stamps ts=now itself
    with open(path, "a") as f:
        f.write(json.dumps(dict(schema=OTHER_SCHEMA, key="old",
                                ts=now - 400 * 86400.0)) + "\n")

    monkeypatch.setenv("RACE_TUNING_MAX_AGE_DAYS", "30")
    assert eviction_limits() == (30 * 86400.0, None)
    s2 = TuningStore(path)
    removed = s2.compact(now=now)
    assert removed == 1
    assert s2.get("stale") is None
    assert s2.get("fresh") is not None and s2.get("unstamped") is not None
    # the ancient foreign line is untouched: not ours to age out
    on_disk = [json.loads(l) for l in path.read_text().splitlines()]
    assert any(r["key"] == "old" for r in on_disk)


def test_compact_evicts_by_size_keeping_newest(tmp_path, monkeypatch):
    import time as _time

    now = _time.time()
    path = tmp_path / "t.jsonl"
    store = TuningStore(path)
    for i in range(6):
        store.put(dict(_rec(f"k{i}"), ts=now - i * 100.0))  # k0 newest
    monkeypatch.setenv("RACE_TUNING_MAX_RECORDS", "2")
    s2 = TuningStore(path)
    removed = s2.compact(now=now)
    assert removed == 4
    assert sorted(TuningStore(path).keys()) == ["k0", "k1"]


def test_compact_unstamped_records_evict_first(tmp_path, monkeypatch):
    """Records without a ``ts`` sort oldest under a size cap (they re-tune
    once and come back stamped), never shadowing stamped records."""
    import time as _time

    now = _time.time()
    path = tmp_path / "t.jsonl"
    lines = [json.dumps(dict(_rec("legacy"), schema=SCHEMA_VERSION)),  # no ts
             json.dumps(dict(_rec("stamped"), schema=SCHEMA_VERSION,
                             ts=now))]
    path.write_text("\n".join(lines) + "\n")
    monkeypatch.setenv("RACE_TUNING_MAX_RECORDS", "1")
    store = TuningStore(path)
    assert store.compact(now=now) == 1
    assert store.get("stamped") is not None
    assert store.get("legacy") is None


def test_eviction_limits_validation(monkeypatch):
    from repro_torch.tuning.store import eviction_limits

    assert eviction_limits() == (None, None)
    monkeypatch.setenv("RACE_TUNING_MAX_AGE_DAYS", "0.5")
    monkeypatch.setenv("RACE_TUNING_MAX_RECORDS", "100")
    assert eviction_limits() == (0.5 * 86400.0, 100)
    monkeypatch.setenv("RACE_TUNING_MAX_RECORDS", "zero")
    with pytest.raises(ValueError):
        eviction_limits()
    monkeypatch.setenv("RACE_TUNING_MAX_RECORDS", "-3")
    with pytest.raises(ValueError):
        eviction_limits()


def test_put_stamps_ts(tmp_path):
    path = tmp_path / "t.jsonl"
    store = TuningStore(path)
    store.put(_rec("a"))
    rec = json.loads(path.read_text().splitlines()[0])
    assert isinstance(rec["ts"], float) and rec["ts"] > 0


def test_store_file_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("RACE_TUNING_CACHE", str(tmp_path / "d"))
    assert store_file() == tmp_path / "d" / "tuning.jsonl"
    monkeypatch.setenv("RACE_TUNING_CACHE", str(tmp_path / "f.jsonl"))
    assert store_file() == tmp_path / "f.jsonl"


# ---------------------------------------------------------------------------
# the measured, gated search
# ---------------------------------------------------------------------------


def test_autotune_winner_never_slower_than_default():
    case = _case()
    env = build_env(case)
    dec = autotune(case.program, env, levels=(0, 3), quick=True, repeats=2,
                   warmup=1, device=CPU)
    assert not dec.from_cache and dec.search_seconds > 0
    assert dec.measurements and all(
        m.status in ("ok", "gated", "error") for m in dec.measurements)
    # both backends were measured, the kernel at the chooser's tile
    assert {m.config.backend for m in dec.measurements if m.ok} == {
        "torch", "hopper"}
    # the static default is always part of the measured space, so the
    # winner is never slower than it (the acceptance invariant)
    assert dec.tuned_us <= dec.default_us
    assert any(m.config == dec.choice and m.ok for m in dec.measurements)


def test_autotune_correctness_gate_rejects():
    """tolerance=0 keeps only bitwise-faithful candidates: reassociation
    changes summation order, so r3 must be gated and r0 must win."""
    case = _case("calc_tpoints", 12)
    env = build_env(case)
    dec = autotune(case.program, env, tolerance=0.0, device=CPU, **QUICK)
    assert dec.choice.reassociate == 0
    gated = [m for m in dec.measurements if m.status == "gated"]
    assert gated and all(m.rel_err > 0 for m in gated)
    assert all("baseline" in m.detail for m in gated)


def test_autotune_second_call_is_store_hit():
    case = _case()
    env = build_env(case)
    dec1 = autotune(case.program, env, device=CPU, **QUICK)
    dec2 = autotune(case.program, env, device=CPU, **QUICK)
    assert dec2.from_cache and not dec2.measurements
    assert dec2.choice == dec1.choice
    assert dec2.tuned_us == pytest.approx(dec1.tuned_us)
    # force=True re-measures in place
    dec3 = autotune(case.program, env, force=True, device=CPU, **QUICK)
    assert not dec3.from_cache and dec3.measurements


def test_autotune_key_separates_env_signatures():
    case12, case14 = _case(n=12), _case(n=14)
    assert program_hash(case12.program) != program_hash(case14.program)
    env = build_env(case12)
    autotune(case12.program, env, device=CPU, **QUICK)
    env64 = build_env(case12, dtype=np.float64)  # same program, new dtype
    dec = autotune(case12.program, env64, device=CPU, **QUICK)
    assert not dec.from_cache  # dtype is part of the key: fresh search


def test_autotune_without_device_raises_without_gpu(monkeypatch):
    """``device=None`` means cuda: with no card the tuner raises before it
    measures or stores anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = _case()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune(case.program, build_env(case), **QUICK)
    assert len(default_store()) == 0


# ---------------------------------------------------------------------------
# cross-process persistence (the acceptance pin)
# ---------------------------------------------------------------------------

_CHILD = """
import json
import numpy as np
from repro_torch.apps.paper_kernels import get_case
from repro_torch.testing.differential import build_env, env_to_torch
from repro_torch.core import compile_cache
from repro_torch.core.race import race
from repro_torch.core.executor import compile_plan
from repro_torch.tuning import autotune

case = get_case("gaussian", 12)
env = build_env(case)
dec = autotune(case.program, env, levels=(0, 3), backends=("torch",),
               repeats=2, warmup=1, device="cpu")
res = race(case.program, reassociate=dec.choice.reassociate)
ex = compile_plan(res.plan, env_to_torch(env, "cpu"), "auto")
print(json.dumps(dict(from_cache=dec.from_cache,
                      n_measurements=len(dec.measurements),
                      choice=dec.choice.as_dict(),
                      consulted_backend=ex.backend,
                      nvcc_runs=compile_cache.counts()["misses"])))
"""


def test_fresh_subprocess_reuses_decision_without_remeasuring():
    case = _case()
    env = build_env(case)
    dec = autotune(case.program, env, device=CPU, **QUICK)
    assert not dec.from_cache  # this process did the search...
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=240)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # ...and a fresh process answers from the on-disk store: no measurement
    assert got["from_cache"] is True
    assert got["n_measurements"] == 0
    assert got["choice"] == dec.choice.as_dict()
    assert got["nvcc_runs"] == 0
    # the serving path applied the stored choice on backend="auto"
    assert got["consulted_backend"] == dec.choice.backend


# ---------------------------------------------------------------------------
# compile_plan consults the store on backend="auto"
# ---------------------------------------------------------------------------


def _stored_hopper(res, env, **blocks):
    key = record_key("plan", plan_hash(res.plan), env_signature(env),
                     runtime_fence(CPU))
    default_store().put(_rec(key, choice=dict(
        reassociate=res.options["reassociate"], backend="hopper",
        **blocks)))


def test_compile_plan_applies_stored_block_config():
    case = _case("gaussian", 14)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    env = _tenv(case)
    chooser = compile_plan(res.plan, env, "hopper").spec.tp.geometry.tile
    _stored_hopper(res, env, block_rows=4, block_cols=0, block_inner=4)
    ex = compile_plan(res.plan, env, "auto")
    assert ex.backend == "hopper"
    assert ex.spec.tp.geometry.tile == (4, 4) != chooser
    # the tuned executor still computes the right answer
    want = compile_plan(res.plan, env, "torch")(env)
    got = ex(env)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # explicit backend requests bypass the store entirely
    assert compile_plan(res.plan, env,
                        "hopper").spec.tp.geometry.tile == chooser


def test_compile_plan_degrades_on_stale_block_config():
    """A stored kernel choice whose tile the chooser cannot honour (a
    hand-edited or bit-rotted record) must degrade to the chooser's tile on
    the same backend — the store contract is 'bad records re-tune', never a
    serving crash."""
    case = _case("gaussian", 14)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    env = _tenv(case)
    chooser = compile_plan(res.plan, env, "hopper").spec.tp.geometry.tile
    _stored_hopper(res, env, block_rows=1000, block_cols=0, block_inner=0)
    ex = compile_plan(res.plan, env, "auto")  # must not raise
    assert ex.backend == "hopper"
    assert ex.spec.tp.geometry.tile == chooser  # not the stale record
    want = compile_plan(res.plan, env, "torch")(env)
    got = ex(env)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_compile_plan_ignores_infeasible_stored_choice():
    """A stale/corrupt record claiming the kernel for an ineligible plan
    must degrade to the probe's choice, not crash the serving path."""
    loops, (i, j) = loopnest(("i", 1, 6), ("j", 1, 6))
    out = arr("out")
    res = race(program(loops, [(out[i, j], mul(Scalar("s"), 2.0))]))
    env = env_to_torch({"s": np.float32(0.5)}, CPU)
    _stored_hopper(res, env, block_rows=0, block_cols=0, block_inner=0)
    ex = compile_plan(res.plan, env, "auto")
    assert ex.backend == "torch"
    np.testing.assert_allclose(ex(env)["out"].numpy(), 1.0)


def test_auto_rechecks_the_store_after_the_interval(monkeypatch):
    """``"auto"`` asks the store again for a plan only
    ``STORE_RECHECK_S`` after its last look (a ``stat`` per call can cost
    100 µs on a network file system); a record written meanwhile is used
    from the first call after the interval."""
    from repro_torch.core import executor

    case = _case("gaussian", 14)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    env = _tenv(case)
    chooser = compile_plan(res.plan, env, "auto").spec.tp.geometry.tile
    _stored_hopper(res, env, block_rows=4, block_cols=0, block_inner=4)
    monkeypatch.setattr(executor, "STORE_RECHECK_S", 3600.0)
    assert compile_plan(res.plan, env, "auto").spec.tp.geometry.tile == (
        chooser)
    monkeypatch.setattr(executor, "STORE_RECHECK_S", 0.0)
    assert compile_plan(res.plan, env, "auto").spec.tp.geometry.tile == (
        4, 4)


# ---------------------------------------------------------------------------
# the tune wiring: RaceResult.tune, race(tune=...), race_kernel(tune=...)
# ---------------------------------------------------------------------------


def test_raceresult_tune_applies_winner():
    case = _case()
    env = build_env(case)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    dec = res.tune(env, device=CPU, **QUICK)
    assert dec.choice.reassociate in (0, 3)
    want = res.run(env, "torch", device=CPU)  # explicit: the untuned path
    got = res.run(env, device=CPU)  # no backend: the tuned winner
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(),
                                   want[k].double().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_race_tune_flag_tunes_on_first_run():
    case = _case()
    env = build_env(case)
    res = race(case.program, tune=dict(QUICK))
    got = res.run(env, device=CPU)  # triggers the search transparently
    assert res._tuned  # the decision is remembered per env signature
    (dec, _target), = res._tuned.values()
    assert dec.choice.backend == "torch"
    want = race(case.program, reassociate=dec.choice.reassociate).run(
        env, "torch", device=CPU)
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(),
                                   want[k].double().numpy(),
                                   rtol=1e-6, err_msg=k)
    # a second result for the same program answers from the store
    res2 = race(case.program, tune=dict(QUICK))
    res2.run(env, device=CPU)
    (dec2, _), = res2._tuned.values()
    assert dec2.from_cache


def test_race_kernel_tune_decorator():
    from repro_torch.frontend import race_kernel

    @race_kernel(tune=dict(QUICK))
    def blur(u, out):
        n, m = u.shape
        for i in range(1, n - 1):
            for j in range(1, m - 1):
                out[i, j] = (u[i - 1, j] + u[i + 1, j]
                             + u[i, j - 1] + u[i, j + 1]) / 4.0

    rng = np.random.default_rng(0)
    env = {"u": rng.random((16, 16), dtype=np.float32),
           "out": np.zeros((16, 16), np.float32)}
    got = blur.run(env, device=CPU)
    want = blur.run(env, backend="torch", device=CPU)
    np.testing.assert_allclose(got["out"].double().numpy(),
                               want["out"].double().numpy(), rtol=1e-4)
    (res,) = blur._results.values()
    assert res._tuned


# ---------------------------------------------------------------------------
# executor-layer env knobs
# ---------------------------------------------------------------------------


def test_executor_cache_size_env_knob(monkeypatch):
    monkeypatch.setenv("RACE_EXECUTOR_CACHE_SIZE", "2")
    cache = ExecutorCache()  # capacity comes from the env knob
    assert cache.maxsize == 2
    case = _case()
    res = race(case.program)
    for dt in (np.float32, np.float64, np.float16):
        compile_plan(res.plan, _tenv(case, dt), "torch", cache=cache)
    info = cache.cache_info()
    assert info["maxsize"] == 2 and info["currsize"] == 2
    assert info["evictions"] == 1 and info["misses"] == 3


def test_executor_cache_size_env_knob_rejects_garbage(monkeypatch):
    monkeypatch.setenv("RACE_EXECUTOR_CACHE_SIZE", "zero")
    with pytest.raises(ValueError, match="RACE_EXECUTOR_CACHE_SIZE"):
        ExecutorCache()
    monkeypatch.setenv("RACE_EXECUTOR_CACHE_SIZE", "0")
    with pytest.raises(ValueError, match=">= 1"):
        ExecutorCache()


def test_race_backend_env_knob(monkeypatch):
    case = _case()
    monkeypatch.setenv("RACE_BACKEND", "torch")
    assert default_backend() == "torch"
    res = race(case.program)  # no explicit backend: the knob decides
    assert res.options["backend"] == "torch"
    assert res.select_backend().backend == "torch"
    # explicit caller choice always wins over the knob
    assert race(case.program, backend="auto").options["backend"] == "auto"
    monkeypatch.setenv("RACE_BACKEND", "vulkan")
    with pytest.raises(ValueError, match="RACE_BACKEND"):
        race(case.program)


# ---------------------------------------------------------------------------
# the innermost-tile axis (block_inner)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,bi", [("gaussian", 24, 8), ("psinv", 12, 4)])
def test_block_inner_differentially_correct(name, n, bi):
    report = run_case(get_case(name, n), reassociate_levels=(0, 3),
                      block_inner=bi, device=CPU)
    assert not report.failures()
    assert all(c.status == "ok" for c in report.combos
               if c.backend == "hopper")


# ---------------------------------------------------------------------------
# regression pins for the five tuning-layer bugs of the reference
# ---------------------------------------------------------------------------


def test_tune_on_esr_result_rebuilds_non_esr_target():
    """``RaceResult.tune()`` on an ``esr=True`` result must not forward
    ``esr`` into the tuner's rebuilds: ESR is a comparison baseline, never a
    tuning dimension, so tune rebuilds a non-ESR target."""
    case = _case()
    env = build_env(case)
    res = race(case.program, esr=True)
    dec = res.tune(env, device=CPU, **QUICK)
    assert dec.choice.backend == "torch"
    ((_, target),) = res._tuned.values()
    assert target.options["esr"] is False
    assert target is not res
    want = race(case.program, reassociate=dec.choice.reassociate).run(
        env, "torch", device=CPU)
    got = res.run(env, device=CPU)  # routed through the rebuilt target
    for k in want:
        np.testing.assert_allclose(got[k].double().numpy(),
                                   want[k].double().numpy(),
                                   rtol=1e-4, err_msg=k)


def test_run_batch_traceable_under_jit_and_grad():
    """``run_batch`` must not read the stacked batch on the host to build
    the tuning example unless a search needs it, and a stacked batch that
    requires grad must run and differentiate (the port's form of the
    reference's jit/grad pin)."""
    case = _case("gaussian", 12)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div, tune=dict(QUICK))
    env = _tenv(case)
    outs = {st.lhs.name for st in case.program.body}
    arr_key = next(k for k, v in env.items() if v.dim() and k not in outs)
    stacked = {k: torch.stack([v] * 3) for k, v in env.items()}
    stacked[arr_key] = stacked[arr_key].clone().requires_grad_()
    out = res.run_batch(stacked, device=CPU)  # tunes on element 0
    (dec, _), = res._tuned.values()
    want = res.run(env, "torch", device=CPU)
    for k in want:
        np.testing.assert_allclose(out[k][0].detach().double().numpy(),
                                   want[k].double().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    loss = sum(v.sum() for v in out.values())
    (g,) = torch.autograd.grad(loss, [stacked[arr_key]])
    assert torch.isfinite(g).all()


def test_program_store_key_includes_search_options():
    """The program-level store key holds the search-shaping options, so a
    narrowed search (``backends=("torch",)``, fewer levels, ...) never
    answers a later full-space request."""
    case = _case()
    env = build_env(case)
    wide = dict(levels=(0, 3), backends=None, repeats=2, warmup=1,
                quick=True, device=CPU)
    d1 = autotune(case.program, env, **wide)
    assert not d1.from_cache
    d2 = autotune(case.program, env, device=CPU, **QUICK)  # narrower
    assert not d2.from_cache  # must NOT be answered by the wider record
    assert d2.key != d1.key
    # both records persist independently and each re-hits its own search
    assert autotune(case.program, env, **wide).from_cache
    assert autotune(case.program, env, device=CPU, **QUICK).from_cache


def test_store_rewrites_preserve_foreign_schema_lines(tmp_path):
    """``put``/``compact`` must keep every record owned by another library
    version sharing the store file: foreign-schema lines round-trip
    verbatim (deduped by their own (schema, key))."""
    path = tmp_path / "t.jsonl"
    future_old = json.dumps(dict(schema=OTHER_SCHEMA, key="f", gen=0))
    future_new = json.dumps(dict(schema=OTHER_SCHEMA, key="f", gen=1))
    legacy = json.dumps(dict(schema=0, key="l", data="legacy"))
    path.write_text("\n".join([future_old, future_new, legacy]) + "\n")
    s = TuningStore(path)
    assert len(s) == 0  # foreign records stay invisible to this version...
    s.put(_rec("mine"))  # ...but a rewrite must not destroy them
    on_disk = [json.loads(x) for x in path.read_text().splitlines()]
    by_schema_key = {(r["schema"], r["key"]): r for r in on_disk}
    assert (OTHER_SCHEMA, "f") in by_schema_key
    assert by_schema_key[(OTHER_SCHEMA, "f")]["gen"] == 1  # deduped
    assert (0, "l") in by_schema_key
    assert (SCHEMA_VERSION, "mine") in by_schema_key
    assert len(on_disk) == 3
    # compaction keeps them too, and doesn't loop re-removing them
    assert s.compact() == 0
    assert TuningStore(path).get("mine") is not None
    assert len(path.read_text().splitlines()) == 3


def test_noise_margin_tie_rule_shared_by_program_and_plan_records():
    """The noise-margin tie fallback is one helper, ``_prefer_default``,
    shared by the program pick and the per-plan records: with a total noise
    margin every winner ties, so the program record AND every plan record
    keep their defaults."""
    from repro_torch.tuning.measure import Measurement
    from repro_torch.tuning.space import Config
    from repro_torch.tuning.tuner import _prefer_default

    # the helper itself: beat-the-margin wins, tie keeps default
    fast = Measurement(Config(3, "torch"), "ok", us=50.0)
    dflt = Measurement(Config(0, "torch"), "ok", us=100.0)
    close = Measurement(Config(3, "torch"), "ok", us=99.0)
    assert _prefer_default(fast, dflt, dflt.config, 0.03) is fast
    assert _prefer_default(close, dflt, dflt.config, 0.03) is dflt
    assert _prefer_default(fast, None, dflt.config, 0.03) is fast

    # both call sites, end to end: noise_margin=1.0 makes every tie
    case = _case()
    env = build_env(case)
    dec = autotune(case.program, env, noise_margin=1.0, device=CPU, **QUICK)
    assert dec.choice == dec.default
    sig = env_signature(_tenv(case))
    s = default_store()
    for lvl in (0, 3):
        res = race(case.program, reassociate=lvl)
        rec = s.get(record_key("plan", plan_hash(res.plan), sig,
                               runtime_fence(CPU)))
        assert rec is not None  # per-plan record: same conservative rule
        assert rec["choice"]["backend"] == "torch"
        assert rec["choice"]["reassociate"] == lvl


def test_block_inner_is_part_of_the_executor_key():
    case = _case("gaussian", 14)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    env = _tenv(case)
    full = compile_plan(res.plan, env, "hopper")
    tiled = compile_plan(res.plan, env, "hopper", block_inner=4)
    assert full is not tiled  # distinct specializations, both cached
    assert compile_plan(res.plan, env, "hopper", block_inner=4) is tiled
    for k, v in full(env).items():
        np.testing.assert_allclose(tiled(env)[k].numpy(), v.numpy(),
                                   rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the port's grid (K1's tile chooser overrides)
# ---------------------------------------------------------------------------


def test_block_grid_holds_the_chooser_and_the_swept_tiles():
    from repro_torch.tuning.space import block_grid

    three = race(get_case("j3d27pt", 12).program).plan
    assert block_grid(three) == [(0, 0, 0), (32, 16, 0), (64, 16, 0),
                                 (16, 64, 0)]
    two = race(get_case("hdifft_gm", 14).program).plan
    assert block_grid(two) == [(0, 0, 0), (512, 0, 0), (2048, 0, 0)]
    # a long stream level adds the chooser's tile at half its segment
    long = race(get_case("hdifft_gm", 300).program).plan
    grid = block_grid(long)
    assert len(grid) == 4 and grid[-1][:2] == (0, 0) and grid[-1][2] > 0


def test_candidates_the_chooser_refuses_are_errors_not_crashes():
    """Grid points past an extent are measured as ``error`` candidates with
    their reason; float16 envs take kernel candidates that pass the gate,
    int32 envs none (``hopper-dtype``)."""
    case = _case("j3d27pt", 12)
    dec = autotune(case.program, build_env(case), levels=(3,),
                   default_reassociate=3, repeats=1, warmup=1, device=CPU)
    errors = [m for m in dec.measurements if m.status == "error"]
    assert len(errors) == 3
    assert all("tile-extent" in m.detail for m in errors)
    assert dec.choice in [m.config for m in dec.measurements if m.ok]
    dec16 = autotune(case.program, build_env(case, np.float16), levels=(3,),
                     default_reassociate=3, repeats=1, warmup=1, device=CPU)
    assert "hopper" in {m.config.backend for m in dec16.measurements if m.ok}
    dec_int = autotune(case.program, build_env(case, np.int32), levels=(3,),
                       default_reassociate=3, repeats=1, warmup=1,
                       device=CPU)
    assert {m.config.backend for m in dec_int.measurements} == {"torch"}


# ---------------------------------------------------------------------------
# parity with the reference tuner on the same inputs
# ---------------------------------------------------------------------------


def _plan_record_hashes(store) -> set:
    return {rec["hash"] for rec in (store.get(k) for k in store.keys())
            if rec.get("kind") == "plan"}


def test_tuner_plans_have_the_reference_plan_hashes():
    """For each reassociation level, the plan the port's tuner measured
    and recorded (in one store file shared with the reference's) has the
    reference tuner's plan hash."""
    from repro.core.executor import plan_hash as ref_plan_hash
    from repro.core.race import race as ref_race

    ref_executor_cache().clear()
    case, ref_case = _case(), ref_get_case("gaussian", 12)
    levels = (0, 3, 4)
    ref_autotune(ref_case.program, ref_build_env(ref_case), levels=levels,
                 backends=("xla",), repeats=1, warmup=1)
    autotune(case.program, build_env(case), levels=levels,
             backends=("torch",), repeats=1, warmup=1, device=CPU)
    assert ref_default_store().path == default_store().path
    port_hashes = _plan_record_hashes(default_store())
    assert port_hashes == _plan_record_hashes(ref_default_store())
    for lvl in levels:
        h = plan_hash(race(case.program, reassociate=lvl).plan)
        assert h == ref_plan_hash(ref_race(ref_case.program,
                                           reassociate=lvl).plan)
        assert h in port_hashes


def _wrong_at(module, monkeypatch, bad_plan_hash, hash_of):
    """Patch ``module.compile_plan`` so the executor of the plan hashing to
    ``bad_plan_hash`` returns every output times 1.01."""
    real = module.compile_plan

    class Wrong:
        def __init__(self, ex):
            self._ex = ex

        def __getattr__(self, name):
            return getattr(self._ex, name)

        def __call__(self, env):
            return {k: v * 1.01 for k, v in self._ex(env).items()}

    def patched(plan, *a, **kw):
        ex = real(plan, *a, **kw)
        return Wrong(ex) if hash_of(plan) == bad_plan_hash else ex

    monkeypatch.setattr(module, "compile_plan", patched)


def test_candidate_forced_wrong_is_gated_in_both(monkeypatch):
    from repro.core.executor import plan_hash as ref_plan_hash
    from repro.core.race import race as ref_race

    ref_executor_cache().clear()
    case, ref_case = _case(), ref_get_case("gaussian", 12)
    bad = plan_hash(race(case.program, reassociate=3).plan)
    assert bad == ref_plan_hash(ref_race(ref_case.program,
                                         reassociate=3).plan)
    _wrong_at(port_measure, monkeypatch, bad, plan_hash)
    _wrong_at(ref_measure, monkeypatch, bad, ref_plan_hash)
    ref_dec = ref_autotune(ref_case.program, ref_build_env(ref_case),
                           levels=(0, 3), backends=("xla",), repeats=1,
                           warmup=1)
    dec = autotune(case.program, build_env(case), levels=(0, 3),
                   backends=("torch",), repeats=1, warmup=1, device=CPU)
    for d in (ref_dec, dec):
        status = {m.config.reassociate: m.status for m in d.measurements}
        assert status == {0: "ok", 3: "gated"}
        (gated,) = [m for m in d.measurements if m.status == "gated"]
        assert gated.rel_err == pytest.approx(0.01, rel=0.05)
        assert d.choice.reassociate == 0


def test_nan_candidate_is_gated(monkeypatch):
    """A candidate that writes a NaN scores ``inf`` and is gated, on tensors
    and on arrays alike, so it can never be the stored winner."""
    a = np.ones((3, 4), np.float32)
    b = a.copy()
    b[1, 2] = np.nan
    for got, want in ((b, a), (a, b), (torch.from_numpy(b),
                                       torch.from_numpy(a))):
        assert rel_err({"u": got}, {"u": want}) == float("inf")
    case = _case()
    bad = plan_hash(race(case.program, reassociate=3).plan)
    real = port_measure.compile_plan

    class Nan:
        def __init__(self, ex):
            self._ex = ex

        def __getattr__(self, name):
            return getattr(self._ex, name)

        def __call__(self, env):
            out = {k: v.clone() for k, v in self._ex(env).items()}
            for v in out.values():
                v.view(-1)[0] = float("nan")
            return out

    def patched(plan, *a, **kw):
        ex = real(plan, *a, **kw)
        return Nan(ex) if plan_hash(plan) == bad else ex

    monkeypatch.setattr(port_measure, "compile_plan", patched)
    dec = autotune(case.program, build_env(case), levels=(0, 3),
                   backends=("torch",), repeats=1, warmup=1, device=CPU)
    status = {m.config.reassociate: (m.status, m.rel_err)
              for m in dec.measurements}
    assert status == {0: ("ok", 0.0), 3: ("gated", float("inf"))}
    assert dec.choice.reassociate == 0


def test_kernel_launch_failure_ends_the_search(monkeypatch):
    """K1 failing to launch is a fault, not a candidate's fate: autotune
    raises and writes no record, so the plain ``"torch"`` candidate can
    never become the stored winner because the kernel broke."""
    from repro_torch.lowering.emit import LoweredStencil

    def broken(self, env):
        raise RuntimeError("race stencil kernel launch failed: CUDA error 1 "
                           "(invalid argument)")

    monkeypatch.setattr(LoweredStencil, "apply", broken)
    case = _case()
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune(case.program, build_env(case), levels=(0,), repeats=1,
                 warmup=1, device=CPU)
    assert default_store().keys() == []
    # the chooser's refusals stay error candidates (a tile past an extent)
    m = port_measure.measure_candidate(
        race(case.program).plan,
        port_measure.Config(0, "hopper", 64, 0, 0), _tenv(case), {}, 1e-4)
    assert m.status == "error" and "tile-extent" in m.detail


def test_tie_rule_keeps_the_default_in_both():
    ref_executor_cache().clear()
    case, ref_case = _case(), ref_get_case("gaussian", 12)
    ref_dec = ref_autotune(ref_case.program, ref_build_env(ref_case),
                           levels=(0, 3), backends=("xla",), repeats=1,
                           warmup=1, noise_margin=1.0, default_reassociate=3)
    dec = autotune(case.program, build_env(case), levels=(0, 3),
                   backends=("torch",), repeats=1, warmup=1,
                   noise_margin=1.0, default_reassociate=3, device=CPU)
    for d in (ref_dec, dec):
        assert d.choice == d.default and d.choice.reassociate == 3
    assert dec.default_us == dec.tuned_us


def test_one_store_file_holds_both_packages_records(tmp_path):
    """A record written by ``repro.tuning.store`` and one by
    ``repro_torch.tuning.store`` in one file both survive the other's
    ``put`` and ``compact``, and neither answers the other's lookup."""
    path = tmp_path / "shared.jsonl"
    ref_s, port_s = ref_store.TuningStore(path), TuningStore(path)
    ref_sig = (("u", (12, 12), "float32", False),)
    port_sig = (("u", (12, 12), "float32"),)
    ref_key = ref_store.record_key("plan", "h", ref_sig,
                                   dict(device="cpu", jax="0"))
    port_key = record_key("plan", "h", port_sig, runtime_fence(CPU))
    for gen in range(3):  # stale duplicates for compaction to drop
        ref_s.put(dict(key=ref_key, kind="plan", gen=gen,
                       choice=dict(backend="xla")))
        port_s.put(_rec(port_key))
        port_s.put(dict(_rec("shared-key"), gen=gen))
        ref_s.put(dict(key="shared-key", kind="plan", gen=10 + gen,
                       choice=dict(backend="xla")))
    with open(path, "a") as f:  # an appended duplicate of each
        f.write(json.dumps(dict(ref_s.get(ref_key), gen=9)) + "\n")
        f.write(json.dumps(dict(port_s.get(port_key), gen=9)) + "\n")
    assert port_s.compact() >= 1
    assert ref_s.compact() == 0  # the port's rewrite left one line per key
    for s in (ref_store.TuningStore(path), TuningStore(path)):
        assert len(s) == 2  # its own two records, the other's invisible
    assert ref_s.get(ref_key)["gen"] == 9
    assert port_s.get(port_key)["gen"] == 9
    assert ref_s.get("shared-key")["gen"] == 12
    assert port_s.get("shared-key")["gen"] == 2
    assert ref_s.get(port_key) is None and port_s.get(ref_key) is None
    on_disk = [json.loads(l) for l in path.read_text().splitlines()]
    assert sorted(map(repr, (r["schema"] for r in on_disk))) == sorted(
        map(repr, [1, 1, SCHEMA_VERSION, SCHEMA_VERSION]))
