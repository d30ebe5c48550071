"""The port's serving runtime, warmup and kernel cache
(``repro_torch.serve``, ``repro_torch.core.compile_cache``) against the
reference's ``repro.serve``.

The 18 tests of ``tests/test_serve.py`` on the port (CPU:
``device="cpu"``), each under its reference name, plus parity: coalesced
results on ``"torch"`` and on ``"hopper"`` (K1's tile emulator here) equal
``run`` of the same env, and equal the reference ``ServeRuntime``'s outputs
on ``"xla"`` for the same ``build_env`` arrays within ``plan``.

Where a reference test does not carry over as it stands:

  * ``test_synthetic_env_round_trips_weak_scalars``: torch has no weak
    types, so the port's signature has three fields; the test holds the
    round trip of 0-d tensors of each dtype instead;
  * ``test_compile_cache_serves_rebuild_after_eviction``: the port's
    persistent cache is K1's library directory, and a CPU run builds no
    kernel, so nvcc is stood in for by a script that runs gcc on a C
    source: the first build is a miss, the load after an eviction a hit;
  * ``test_compile_cache_env_knob``: the cache is always on (the knob moves
    the directory), so with the knob unset ``enabled()`` stays true and
    ``cache_dir()`` is ``build/repro_torch/``.
"""
import shutil
import threading
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_get_case
from repro.core.executor import executor_cache as ref_executor_cache
from repro.core.race import race as ref_race
from repro.serve import ServeRuntime as RefServeRuntime
from repro.testing.differential import build_env as ref_build_env
from repro_torch.apps.paper_kernels import get_case
from repro_torch.core import compile_cache
from repro_torch.core.executor import (compile_plan, env_signature,
                                       env_to_torch, executor_cache,
                                       host_signature, plan_hash)
from repro_torch.core.race import race
from repro_torch.kernels import build
from repro_torch.serve import (ServeRejected, ServeRuntime, synthetic_env,
                               warmup)
from repro_torch.serve.runtime import ServeRuntime as _SR
from repro_torch.testing.differential import (build_env, default_tolerances,
                                              rel_err)

pytestmark = pytest.mark.port

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_cache():
    executor_cache().clear()
    yield
    executor_cache().clear()


def _res(name="gaussian", n=12):
    case = get_case(name, n)
    return case, race(case.program, reassociate=case.reassociate,
                      rewrite_div=case.rewrite_div)


def _direct(res, env, backend="torch"):
    return {k: v.numpy() for k, v in res.run(env, backend,
                                              device=CPU).items()}


def _outputs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-6)


def _rt(**kw):
    kw.setdefault("backend", "torch")
    return ServeRuntime(device=CPU, **kw)


# ---------------------------------------------------------------------------
# batching correctness
# ---------------------------------------------------------------------------


def test_coalesced_results_equal_direct_run():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(6)]
    want = [_direct(res, e) for e in envs]
    with _rt(max_batch=4, window_us=20000, workers=1) as rt:
        futs = [rt.submit(res.plan, e) for e in envs]
        got = [f.result(timeout=120) for f in futs]
        stats = rt.stats()
    for g, w in zip(got, want):
        _outputs_equal(g, w)
    # the window coalesced: fewer dispatches than requests
    assert stats["batches"] < stats["submitted"] == 6
    assert stats["completed"] == 6 and stats["max_batch"] >= 2


def test_single_and_batched_paths_return_host_arrays():
    case, res = _res()
    env = build_env(case)
    with _rt(max_batch=4, window_us=0, workers=1) as rt:
        lone = rt.run(res.plan, env, timeout=120)
        futs = [rt.submit(res.plan, build_env(case, seed=s))
                for s in range(4)]
        rode = [f.result(timeout=120) for f in futs]
    for out in [lone] + rode:
        for v in out.values():
            assert isinstance(v, np.ndarray)


def test_submit_many_equals_per_submit():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(5)]
    want = [_direct(res, e) for e in envs]
    with _rt(max_batch=8, window_us=10000, workers=1) as rt:
        futs = rt.submit_many(res.plan, envs)
        assert len(futs) == 5
        for f, w in zip(futs, want):
            _outputs_equal(f.result(timeout=120), w)
        assert rt.submit_many(res.plan, []) == []


def test_accepts_race_result_and_bare_plan():
    case, res = _res()
    env = build_env(case)
    want = _direct(res, env)
    with _rt(window_us=0) as rt:
        _outputs_equal(rt.run(res, env, timeout=120), want)
        _outputs_equal(rt.run(res.plan, env, timeout=120), want)
    with pytest.raises(TypeError, match="Plan or RaceResult"):
        with _rt(window_us=0) as rt:
            rt.submit("nonsense", env)


def test_window_groups_stragglers_into_one_batch():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(3)]
    with _rt(max_batch=8, window_us=50000, workers=1) as rt:
        rt.run(res.plan, envs[0], timeout=120)  # prime executor + paths
        futs = [rt.submit(res.plan, e) for e in envs]
        for f in futs:
            f.result(timeout=120)
        stats = rt.stats()
    # 3 primed submits inside one 50ms window -> exactly one dispatch
    assert stats["batches"] == 2 and stats["max_batch"] == 3


# ---------------------------------------------------------------------------
# backpressure / failure / shutdown
# ---------------------------------------------------------------------------


def test_queue_full_rejects_with_structured_code(monkeypatch):
    monkeypatch.setattr(_SR, "_worker", lambda self: time.sleep(3600))
    case, res = _res()
    env = build_env(case)
    rt = _rt(max_batch=2, window_us=0, workers=1, queue_limit=3)
    futs = [rt.submit(res.plan, env) for _ in range(3)]
    with pytest.raises(ServeRejected) as ei:
        rt.submit(res.plan, env)
    assert ei.value.code == "queue-full"
    # burst rejection is atomic: nothing partially queued
    with pytest.raises(ServeRejected):
        rt.submit_many(res.plan, [env, env])
    assert rt.stats()["queue_depth"] == 3
    rt.close(flush=False, timeout=0.1)
    for f in futs:
        with pytest.raises(ServeRejected):
            f.result(timeout=5)


def test_executor_failure_propagates_to_every_future():
    case, res = _res()
    good = build_env(case)
    bad = {k: v for k, v in good.items() if k != sorted(good)[0]}
    with _rt(max_batch=4, window_us=20000, workers=1) as rt:
        futs = rt.submit_many(res.plan, [bad, bad])
        errs = [pytest.raises(Exception, f.result, 120) for f in futs]
        assert all(errs)
        stats = rt.stats()
        assert stats["failed"] == 2
        # the runtime survives a failed batch: a good request still works
        _outputs_equal(rt.run(res.plan, good, timeout=120),
                       _direct(res, good))


def test_close_without_flush_rejects_pending(monkeypatch):
    monkeypatch.setattr(_SR, "_worker", lambda self: time.sleep(3600))
    case, res = _res()
    env = build_env(case)
    rt = _rt(max_batch=2, window_us=0, workers=1)
    futs = [rt.submit(res.plan, env) for _ in range(3)]
    rt.close(flush=False, timeout=0.1)
    for f in futs:
        with pytest.raises(ServeRejected) as ei:
            f.result(timeout=5)
        assert ei.value.code == "shutdown"
    with pytest.raises(ServeRejected) as ei:
        rt.submit(res.plan, env)
    assert ei.value.code == "shutdown"
    assert rt.stats()["rejected"] == 4


def test_close_with_flush_serves_queued_requests():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(4)]
    want = [_direct(res, e) for e in envs]
    rt = _rt(max_batch=2, window_us=5000, workers=1)
    futs = [rt.submit(res.plan, e) for e in envs]
    rt.close(flush=True, timeout=120)
    for f, w in zip(futs, want):
        _outputs_equal(f.result(timeout=1), w)


# ---------------------------------------------------------------------------
# warmup / zero cold start
# ---------------------------------------------------------------------------


def test_synthetic_env_round_trips_signature():
    case, _ = _res("calc_tpoints", 12)
    env = env_to_torch(build_env(case), CPU)
    sig = env_signature(env)
    assert env_signature(synthetic_env(sig)) == sig


def test_synthetic_env_round_trips_weak_scalars():
    sig = (("a", (4, 4), "float32"), ("b", (), "float64"),
           ("c", (), "int32"), ("d", (), "bool"))
    env = synthetic_env(sig)
    assert env_signature(env) == sig == host_signature(env)
    assert all(isinstance(v, torch.Tensor) for v in env.values())
    assert env["d"].item() is True and env["b"].item() == 0.5


def test_warmup_reports_and_primes_executor():
    case, res = _res()
    env = build_env(case)
    sig = env_signature(env_to_torch(env, CPU))
    reports = warmup([(res.plan, env), (res.plan, sig)], backend="torch",
                     device=CPU)
    assert len(reports) == 2
    for rep in reports:
        assert rep["plan"] == plan_hash(res.plan)
        assert rep["backend"] == "torch"
        assert rep["build_ms"] >= 0 and rep["first_ms"] >= 0
        assert rep["cache_misses"] == 0
    # the executor is now cached: a fresh compile_plan is a hit
    before = executor_cache().stats_snapshot()
    compile_plan(res.plan, env_to_torch(env, CPU), "torch")
    after = executor_cache().stats_snapshot()
    assert after["hits"] == before["hits"] + 1


def test_runtime_warmup_primes_single_and_batch_paths():
    case, res = _res()
    env = build_env(case)
    with _rt(max_batch=4, window_us=0, workers=1) as rt:
        reports = rt.warmup([(res.plan, env)], backend="torch")
        assert reports[0]["queue_ms"] >= 0
        assert reports[0]["batch_ms"] >= 0
        ex = compile_plan(res.plan, env_to_torch(env, CPU), "torch")
        assert ex.calls >= 1 and ex.batch_calls >= 1


def test_warm_from_store_replays_fabricated_record(tmp_path):
    from repro_torch.serve import warm_from_store
    from repro_torch.serve.warm import store_plan_keys
    from repro_torch.tuning.store import (TuningStore, record_key,
                                          runtime_fence)

    case, res = _res("gaussian", 12)
    outs = {st.lhs.name for st in case.program.body}
    env = build_env(case)
    sig = host_signature(env)
    # a signature without the output arrays (the kernel makes them) fits too
    sig_in = host_signature({k: v for k, v in env.items() if k not in outs})
    fence = runtime_fence(CPU)
    store = TuningStore(tmp_path / "tuning.jsonl")
    store.put(dict(key=record_key("plan", plan_hash(res.plan), sig, fence),
                   backend="torch", level=case.reassociate))
    store.put(dict(key=record_key("plan", plan_hash(res.plan), sig, fence,
                                  batch=8),
                   backend="torch", level=case.reassociate, batch=8))
    store.put(dict(key=record_key("plan", plan_hash(res.plan), sig_in,
                                  fence), backend="torch"))
    keys = store_plan_keys(store, CPU)
    assert len(keys) == 3 and {k[2] for k in keys} == {0, 8}
    doc = warm_from_store(store, backend="torch", device=CPU)
    # the two records of one (plan, sig) replay once; all three matched
    assert len(doc["warmed"]) == 2 and doc["unmatched"] == []
    assert {r["plan"] for r in doc["warmed"]} == {plan_hash(res.plan)}


def test_warm_from_store_reports_unmatched(tmp_path):
    from repro_torch.serve import warm_from_store
    from repro_torch.tuning.store import (TuningStore, record_key,
                                          runtime_fence)

    case, _ = _res("gaussian", 12)
    sig = host_signature(build_env(case))
    store = TuningStore(tmp_path / "tuning.jsonl")
    store.put(dict(key=record_key("plan", "not-a-real-plan-hash", sig,
                                  runtime_fence(CPU)), backend="torch"))
    doc = warm_from_store(store, backend="torch", device=CPU)
    assert doc["warmed"] == [] and doc["unmatched"] == [
        "not-a-real-plan-hash"]


# ---------------------------------------------------------------------------
# persistent kernel cache (the library directory)
# ---------------------------------------------------------------------------


def _gcc_nvcc(tmp_path, monkeypatch, delay=0.0):
    """Stand nvcc in with a script that compiles its last argument (a C
    source) with gcc into the ``-o`` path; ``delay`` seconds of sleep first
    keep concurrent builds in flight together."""
    script = tmp_path / "fake_nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"sleep {delay}\n"
        'out=""; prev=""; src=""\n'
        'for a in "$@"; do\n'
        '  if [ "$prev" = "-o" ]; then out="$a"; fi\n'
        '  prev="$a"; src="$a"\n'
        "done\n"
        'exec gcc -shared -fPIC -x c -o "$out" "$src"\n')
    script.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_compile_cache_serves_rebuild_after_eviction(tmp_path, monkeypatch):
    # the env knob, not configure(): every build re-reads
    # $RACE_COMPILE_CACHE, so the env var is the authoritative switch
    monkeypatch.setenv(compile_cache.ENV_COMPILE_CACHE, str(tmp_path / "cc"))
    _gcc_nvcc(tmp_path, monkeypatch)
    src = "int twice(int x) { return 2 * x; }\n"
    try:
        assert compile_cache.ensure_enabled()
        c0 = compile_cache.counts()
        lib = build.load(src, {})  # nvcc (the stand-in) runs: a miss
        c1 = compile_cache.counts()
        assert (c1["misses"] - c0["misses"], c1["hits"] - c0["hits"]) == (
            1, 0)
        with build._LIBS_LOCK:  # evict: force a fresh lookup
            build._LIBS.pop(build.library_path(src))
        lib2 = build.load(src, {})
        c2 = compile_cache.counts()
        assert (c2["misses"] - c1["misses"], c2["hits"] - c1["hits"]) == (
            0, 1)  # the library on disk, not a recompilation
        assert c2["requests"] - c0["requests"] == 2
        assert lib2.twice(21) == 42 and lib.twice(2) == 4
        info = compile_cache.info()
        assert info["enabled"] and info["entries"] == 1
        assert info["path"] == str(tmp_path / "cc")
    finally:
        monkeypatch.delenv(compile_cache.ENV_COMPILE_CACHE)
        compile_cache.ensure_enabled()
    assert compile_cache.cache_dir() == str(build.BUILD_DIR)


def test_compile_cache_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_COMPILE_CACHE,
                       str(tmp_path / "envcc"))
    try:
        assert compile_cache.ensure_enabled()
        assert compile_cache.cache_dir() == str(tmp_path / "envcc")
        assert build.library_path("// x\n").parent == tmp_path / "envcc"
    finally:
        monkeypatch.delenv(compile_cache.ENV_COMPILE_CACHE)
        compile_cache.ensure_enabled()
    assert compile_cache.enabled()  # always on: the default directory
    assert compile_cache.cache_dir() == str(build.BUILD_DIR)
    assert build.library_path("// x\n").parent == build.BUILD_DIR


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------


def test_runtime_env_knobs(monkeypatch):
    monkeypatch.setenv("RACE_SERVE_MAX_BATCH", "3")
    monkeypatch.setenv("RACE_SERVE_WINDOW_US", "123")
    monkeypatch.setenv("RACE_SERVE_QUEUE", "7")
    monkeypatch.setenv("RACE_SERVE_WORKERS", "2")
    rt = _rt()
    try:
        stats = rt.stats()
        assert stats["max_batch_limit"] == 3
        assert stats["window_us"] == pytest.approx(123)
        assert stats["queue_limit"] == 7
        assert stats["workers"] == 2
    finally:
        rt.close(timeout=5)
    monkeypatch.setenv("RACE_SERVE_MAX_BATCH", "0")
    with pytest.raises(ValueError, match="RACE_SERVE_MAX_BATCH"):
        _rt()


# ---------------------------------------------------------------------------
# the port's own contract, and parity with the reference runtime
# ---------------------------------------------------------------------------


def test_runtime_defaults_to_cuda_and_one_worker_on_cpu(monkeypatch):
    monkeypatch.delenv("RACE_SERVE_WORKERS", raising=False)
    with _rt() as rt:
        assert rt.stats()["workers"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeRuntime()
    from repro_torch.serve import warm_from_store

    with pytest.raises(RuntimeError, match="device='cpu'"):
        warm_from_store()


def test_group_key_reads_the_env_without_copying():
    """The group key's signature is ``env_to_torch``'s (a python float is
    float64), read on the caller's thread without touching a device."""
    case, res = _res()
    env = dict(build_env(case), extra=0.5)
    with _rt() as rt:
        key, *_ = rt._group_for(res.plan, env, None)
    assert key[1] == env_signature(env_to_torch(env, CPU))
    assert dict((nm, dt) for nm, _, dt in key[1])["extra"] == "float64"


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_coalesced_results_equal_run_and_the_reference(backend):
    """Each response equals ``run`` of its env on the same backend (bit for
    bit: the batch is one ``run_batch``), and the reference runtime's
    ``"xla"`` response for the same ``build_env`` arrays within ``plan``."""
    ref_executor_cache().clear()
    case, res = _res("j3d27pt", 10)
    ref_case = ref_get_case("j3d27pt", 10)
    ref_res = ref_race(ref_case.program, reassociate=ref_case.reassociate)
    seeds = range(5)
    envs = [build_env(case, seed=s) for s in seeds]
    with _rt(max_batch=4, window_us=50000, workers=1, backend=backend) as rt:
        got = [f.result(timeout=120) for f in rt.submit_many(res, envs)]
        stats = rt.stats()
    assert stats["batches"] == 2 and stats["coalesced"] == 4
    with RefServeRuntime(max_batch=4, window_us=50000, workers=1,
                         backend="xla") as rt:
        ref = [f.result(timeout=120) for f in rt.submit_many(
            ref_res, [ref_build_env(ref_case, seed=s) for s in seeds])]
    tol = default_tolerances(np.float32)["plan"]
    for env, g, r in zip(envs, got, ref):
        want = _direct(res, env, backend)
        assert set(g) == set(want)
        for k in want:
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
        assert rel_err(g, r) <= tol


def test_auto_batch_dispatch_applies_the_batch_record():
    """On ``"auto"`` a coalesced batch runs the tuning store's record for
    the nearest batch size (here a kernel tile); a batch of one runs the
    per-call path."""
    from repro_torch.tuning.store import (default_store, record_key,
                                          runtime_fence)

    case, res = _res("gaussian", 14)
    env = build_env(case)
    sig = host_signature(env)
    default_store().put(dict(
        key=record_key("plan", plan_hash(res.plan), sig, runtime_fence(CPU),
                       batch=8),
        kind="plan", choice=dict(reassociate=case.reassociate,
                                 backend="hopper", block_rows=4,
                                 block_cols=0, block_inner=4)))
    with _rt(max_batch=4, window_us=50000, workers=1, backend="auto") as rt:
        for f in rt.submit_many(res, [env] * 4):
            f.result(timeout=120)
    tiles = {ex.spec.tp.geometry.tile for ex in executor_cache().executors()
             if ex.spec is not None and ex.batch_calls}
    assert tiles == {(4, 4)}


def test_auto_batch_dispatch_reads_the_store_through_the_memo(monkeypatch):
    """Coalesced ``"auto"`` batches resolve their record through
    ``compile_plan``'s memoized store consult: within
    ``STORE_RECHECK_S`` the store is asked once, not once per batch."""
    from repro_torch.core import executor
    from repro_torch.tuning import store

    calls = []
    real = store.plan_batch_choice

    def counted(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(store, "plan_batch_choice", counted)
    monkeypatch.setattr(executor, "STORE_RECHECK_S", 3600.0)
    case, res = _res("gaussian", 14)
    env = build_env(case)
    with _rt(max_batch=2, window_us=50000, workers=1, backend="auto") as rt:
        for _ in range(3):
            for f in rt.submit_many(res, [env] * 2):
                f.result(timeout=120)
        assert rt.stats()["batches"] == 3
    assert len(calls) == 1


def test_many_clients_and_workers_lose_no_request():
    """More client threads and workers than cores, with a short switch
    interval: every request completes once, with its own env's output."""
    import sys

    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(4)]
    want = [_direct(res, e) for e in envs]
    results, errors = [], []
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _rt(max_batch=4, window_us=200, workers=4) as rt:
            def client(c):
                try:
                    for i in range(8):
                        j = (c + i) % len(envs)
                        out = rt.run(res.plan, envs[j], timeout=120)
                        with lock:
                            results.append((j, out))
                except Exception as e:  # the assertion target
                    with lock:
                        errors.append(e)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            stats = rt.stats()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert len(results) == 128
    assert stats["submitted"] == stats["completed"] == 128
    assert stats["queue_depth"] == 0 and stats["failed"] == 0
    for j, out in results:
        _outputs_equal(out, want[j])
