"""``run_batch`` of the PyTorch port against the reference's: a batch of
same-signature envs (a list, or a stacked dict) in one executor call, equal
per example to ``run`` on both backends (the ``"torch"`` evaluator under
``torch.func.vmap``; ``"hopper"``'s tile emulator per example on the CPU,
the kernel's plain version), and to the reference's ``run_batch`` on
``"xla"`` over the registry within ``plan``; gradients through it; the
launcher's chunking of a batch past ``gridDim.y``; the executor's helpers
and cache; and the output dtype of mixed-dtype envs (an output array of
another dtype than the operands) on every backend."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import CASES, get_case
from repro_torch.core import executor
from repro_torch.lowering.emit import (MAX_GRID_Y, batch_chunks,
                                       chunk_pointers, specialize_stencil)
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)

pytestmark = pytest.mark.port


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _res(name="hdifft_gm", n=14):
    case = get_case(name, n)
    return case, repro_torch.race(case.program,
                                  reassociate=case.reassociate,
                                  rewrite_div=case.rewrite_div)


def _outputs(case) -> set:
    return {st.lhs.name for st in case.program.body}


# ---------------------------------------------------------------------------
# run_batch equals the per-call loop (ports of tests/test_executor.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("gaussian", 14), ("psinv", 10)])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_run_batch_equals_per_call_loop(name, n, backend):
    """Element ``b`` of the batch is ``run(envs[b])`` bit for bit: the
    vmapped evaluator does per example what the evaluator does, and the
    batched kernel's plain version is the emulator per example."""
    case, res = _res(name, n)
    envs = [build_env(case, seed=s) for s in range(3)]
    stacked = res.run_batch(envs, backend, device="cpu")
    for b, env in enumerate(envs):
        per = res.run(env, backend, device="cpu")
        for k in per:
            assert stacked[k].shape == (len(envs),) + tuple(per[k].shape)
            assert torch.equal(stacked[k][b], per[k]), f"{k}[{b}]"


def test_run_batch_accepts_stacked_dict():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(2)]
    stacked_env = {k: np.stack([e[k] for e in envs]) for k in envs[0]}
    a = res.run_batch(envs, "torch", device="cpu")
    b = res.run_batch(stacked_env, "torch", device="cpu")
    c = res.run_batch({k: torch.as_tensor(v) for k, v in
                       stacked_env.items()}, "torch", device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
    # every form reaches one executor
    cache = executor.executor_cache()
    assert len(cache) == 1
    (key,) = cache.keys()
    assert key.env == executor.env_signature(
        env_to_torch(envs[0], "cpu"))


def test_batch_reuses_single_executor():
    case, res = _res()
    envs = [build_env(case, seed=s) for s in range(2)]
    res.run(envs[0], "torch", device="cpu")
    res.run_batch(envs, "torch", device="cpu")
    cache = executor.executor_cache()
    assert len(cache) == 1  # run and run_batch share the specialization
    assert cache.stats_snapshot()["misses"] == 1
    ex = repro_torch.compile_plan(res.plan, env_to_torch(envs[0], "cpu"),
                                  "torch")
    assert ex.calls == 1 and ex.batch_calls == 1


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_run_batch_without_device_raises_without_gpu(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case, res = _res()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        res.run_batch([build_env(case)], backend)
    assert len(executor.executor_cache()) == 0


def test_signature_key_names_the_card_as_its_tensors_do(monkeypatch):
    """A signature with ``device="cuda"`` (``run_batch``'s path) and a
    tensor env made on ``"cuda"`` (``run``'s: its tensors say
    ``cuda:<current>``) reach one executor key."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    case, res = _res()
    sig = executor.env_signature(env_to_torch(build_env(case), "cpu"))
    cache = executor.ExecutorCache()
    ex = repro_torch.compile_plan(res.plan, sig, "torch", device="cuda",
                                  cache=cache)
    assert ex.device == torch.device("cuda", 0)
    assert [k.device for k in cache.keys()] == ["cuda:0"]
    assert repro_torch.compile_plan(res.plan, sig, "torch",
                                    device=torch.device("cuda:0"),
                                    cache=cache) is ex


def test_run_batch_rejects_an_empty_batch_and_bare_scalars():
    case, res = _res("j3d27pt", 8)
    with pytest.raises(ValueError, match="at least one env"):
        res.run_batch([], "torch", device="cpu")
    env = build_env(case)
    stacked = {k: np.stack([v, v]) for k, v in env.items()}
    stacked["jnorm"] = env["jnorm"]
    with pytest.raises(ValueError, match="bare scalar"):
        res.run_batch(stacked, "torch", device="cpu")


# ---------------------------------------------------------------------------
# the registry against the reference's run_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_run_batch_matches_reference_on_registry(name):
    """Both port backends against the reference's ``run_batch(envs,
    "xla")`` (a jitted ``jax.vmap``) on the same numpy batch, within
    ``plan``; the kernel's wrapper takes the batch on the emulator."""
    n = SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    envs = [build_env(pc, seed=s) for s in range(2)]
    ref = ref_race(rc.program, reassociate=rc.reassociate,
                   rewrite_div=rc.rewrite_div)
    want = {k: np.asarray(v) for k, v in ref.run_batch(envs, "xla").items()}
    res = repro_torch.race(pc.program, reassociate=pc.reassociate,
                           rewrite_div=pc.rewrite_div)
    tol = default_tolerances(np.float32)["plan"]
    for backend in ("torch", "hopper"):
        got = res.run_batch(envs, backend, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert rel_err(got, want) <= tol, backend


# ---------------------------------------------------------------------------
# gradients through run_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_run_batch_vmap_grad(backend):
    """Port of ``tests/test_grad.py::test_run_batch_vmap_grad``: the
    gradient through ``run_batch`` equals, per example, the unbatched
    gradient, and the reference's gradient through its ``run_batch``."""
    case = get_case("psinv", 8)
    env = build_env(case)
    res = repro_torch.race(case.program, reassociate=3)
    stacked = {k: np.stack([v] * 3) for k, v in env.items()}
    r = torch.tensor(stacked["R"]).requires_grad_()
    out = res.run_batch({**stacked, "R": r}, backend, device="cpu")
    (g,) = torch.autograd.grad(out["U"].sum(), r)
    r1 = torch.tensor(env["R"]).requires_grad_()
    (gs,) = torch.autograd.grad(
        res.run({**env, "R": r1}, backend, device="cpu")["U"].sum(), r1)
    ref = ref_race(ref_case("psinv", 8).program, reassociate=3)
    gref = np.asarray(jax.grad(lambda x: jnp.sum(jnp.asarray(
        ref.run_batch({**stacked, "R": x}, "xla")["U"])))(
            jnp.asarray(stacked["R"])))
    for b in range(3):
        assert torch.equal(g[b], gs)
    assert rel_err({"R": g}, {"R": gref}) <= default_tolerances(
        np.float32)["grad"]


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,n", [("j3d27pt", 8), ("rprj3", 10),
                                    ("diag2d", 12), ("smooth1d", 20)])
def test_batched_grads_equal_per_example_grads(name, n, backend):
    """Every float input, scalars too (a batched scalar's gradient is
    ``(B,)``), through the adjoint plans' ``run_batch`` (j3d27pt: rank-0
    aux; smooth1d: a 1-D nest) and through the autograd fallback of the
    refused specs (rprj3, diag2d)."""
    case = get_case(name, n)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    envs = [env_to_torch(build_env(case, np.float64, seed=s), "cpu")
            for s in range(3)]
    keys = sorted(k for k, v in envs[0].items()
                  if v.is_floating_point() and k not in _outputs(case))
    p = {k: torch.stack([e[k] for e in envs]).requires_grad_()
         for k in keys}
    out = res.run_batch({**executor.stack_envs(envs, "cpu"), **p}, backend,
                        device="cpu")
    loss = sum((v * v).sum() for v in out.values())
    gb = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
    for b, env in enumerate(envs):
        q = {k: env[k].clone().requires_grad_() for k in keys}
        o = res.run({**env, **q}, backend, device="cpu")
        gs = torch.autograd.grad(sum((v * v).sum() for v in o.values()),
                                 [q[k] for k in keys])
        for k, g in zip(keys, gs):
            assert gb[k].shape == (3,) + tuple(g.shape)
            assert rel_err({k: gb[k][b]}, {k: g}) <= 1e-12, (k, b)


# ---------------------------------------------------------------------------
# the launcher's chunks: gridDim.y holds at most 65,535 examples
# ---------------------------------------------------------------------------


def test_batch_chunks_cover_the_batch_in_grid_sized_launches():
    assert batch_chunks(1) == [(0, 1)]
    assert batch_chunks(MAX_GRID_Y) == [(0, MAX_GRID_Y)]
    big = 2 * MAX_GRID_Y + 7
    chunks = batch_chunks(big)
    assert chunks == [(0, MAX_GRID_Y), (MAX_GRID_Y, MAX_GRID_Y),
                      (2 * MAX_GRID_Y, 7)]
    assert len(batch_chunks(MAX_GRID_Y + 1)) == 2
    with pytest.raises(ValueError):
        batch_chunks(0)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_chunk_pointers_walk_the_batch_on_the_geometry(dt):
    """On a real plan's tile program, for a batch of 65,536 + 3 examples:
    each launch's base pointers are the batch's bases moved by its first
    example's per-example elements, so the launches tile every operand,
    output and scalar row end to end (no data is made)."""
    case, res = _res("j3d27pt", 8)
    shapes = {k: np.shape(v) for k, v in build_env(case).items()}
    spec = specialize_stencil(res.plan, shapes,
                              {k: np.dtype(dt).name for k in shapes})
    tp = spec.tp
    in_elems, out_elems, n_sc = tp.example_elems
    assert in_elems == tuple(int(np.prod(o.shape)) for o in tp.operands)
    assert out_elems == tuple(int(np.prod(o.shape)) for o in tp.outputs)
    assert n_sc == len(tp.scalars) > 0
    itemsize = np.dtype(dt).itemsize
    batch = MAX_GRID_Y + 4
    bases = [1 << 40, 1 << 41, 1 << 42]
    elems = list(in_elems[:1]) + list(out_elems[:1]) + [n_sc]
    ends = list(bases)
    for first, count in batch_chunks(batch):
        ptrs = chunk_pointers(bases, elems, itemsize, first)
        assert ptrs == ends  # each launch starts where the last one ended
        ends = [p + count * n * itemsize for p, n in zip(ptrs, elems)]
    assert ends == [b + batch * n * itemsize for b, n in zip(bases, elems)]
    # the kernel moves each pointer by blockIdx.y times the same counts
    for k, n in enumerate(in_elems):
        assert f"args.in[{k}] + bz * {n}LL;" in spec.source
    for k, n in enumerate(out_elems):
        assert f"args.out[{k}] + bz * {n}LL;" in spec.source
    assert f"args.scalars[bz * {n_sc}LL + 0]" in spec.source
    assert "dim3 grid(" in spec.source and "int batch" in spec.source


# ---------------------------------------------------------------------------
# executor helpers and the cache
# ---------------------------------------------------------------------------


def test_stacking_helpers():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    col = executor._stack_column([a, a + 1], "cpu")
    assert col.dtype == torch.float32 and tuple(col.shape) == (2, 2, 3)
    assert torch.equal(col[1], torch.as_tensor(a + 1))
    scal = executor._stack_column([np.float32(0.5), np.float32(0.25)], "cpu")
    assert scal.dtype == torch.float32 and tuple(scal.shape) == (2,)
    py = executor._stack_column([0.5, 0.25], "cpu")
    assert py.dtype == torch.float64  # as env_to_torch converts a float
    t = torch.ones(3, requires_grad=True)
    stacked = executor._stack_column([t, 2 * t], "cpu")
    (g,) = torch.autograd.grad(stacked.sum(), t)
    assert torch.equal(g, torch.full((3,), 3.0))
    sig = executor.stacked_signature({"u": col, "c": scal})
    assert sig == (("c", (), "float32"), ("u", (2, 3), "float32"))
    with pytest.raises(ValueError, match="bare scalar"):
        executor.stacked_signature({"c": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="device="):
        repro_torch.compile_plan(_res()[1].plan, sig)


def test_executor_cache_helpers_and_configure_cache_evicts():
    cache = executor.executor_cache()
    saved = cache.maxsize
    try:
        plans = []
        for name, n in [("hdifft_gm", 14), ("psinv", 10), ("smooth1d", 24)]:
            case, res = _res(name, n)
            env = env_to_torch(build_env(case), "cpu")
            ex = repro_torch.compile_plan(res.plan, env, "torch")
            plans.append(ex)
            assert ex.core_fn is ex._core
            assert ex.cache_info() == dict(backend="torch", calls=0,
                                           batch_calls=0, kernel_launches=0)
        keys = cache.keys()
        assert len(keys) == 3 and all(k in cache for k in keys)
        info = cache.cache_info()
        assert info["currsize"] == 3 and info["misses"] == 3
        assert info["devices"] == ["cpu"] and info["maxsize"] == saved
        executor.configure_cache(1)
        assert len(cache) == 1 and keys[-1] in cache and keys[0] not in cache
        assert executor.cache_stats()["evictions"] == 2
        executor.clear_cache()
        assert len(cache) == 0 and executor.cache_stats()["misses"] == 0
    finally:
        executor.configure_cache(saved)


def test_concurrent_runs_on_one_result():
    """Port of ``tests/test_executor.py::test_concurrent_runs_on_one_result``,
    mixing ``run`` and ``run_batch``: one miss, one executor, every result
    equal to the warm call's."""
    case, res = _res()
    env = build_env(case)
    want = res.run(env, "torch", device="cpu")["dn"]
    results, errors = [], []

    def worker(k):
        try:
            for _ in range(5):
                if k % 2:
                    results.append(res.run_batch([env, env], "torch",
                                                 device="cpu")["dn"][1])
                else:
                    results.append(res.run(env, "torch", device="cpu")["dn"])
        except Exception as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 40
    for got in results:
        assert torch.equal(got, want)
    cache = executor.executor_cache()
    assert len(cache) == 1 and cache.stats_snapshot()["misses"] == 1
    ex = repro_torch.compile_plan(res.plan, env_to_torch(env, "cpu"), "torch")
    assert ex.calls == 21 and ex.batch_calls == 20


# ---------------------------------------------------------------------------
# the output dtype: the env's output array's, on every backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
@pytest.mark.parametrize("name", ["hdifft_gm", "rhs_ph1", "j3d27pt"])
def test_output_dtype_follows_the_env_output_array(name, backend):
    """float32 operands, a float64 output array: every backend returns
    float64, as the reference's ``"xla"`` (x64 on) does, with values within
    ``plan`` of it; ``run_batch`` too.  The kernel still computes at the
    operand dtype and ``"auto"`` still takes it."""
    n = SWEEP_SIZES[name]
    pc = get_case(name, n)
    outs = _outputs(pc)
    env = {k: (v.astype(np.float64) if k in outs else v)
           for k, v in build_env(pc).items()}
    rc = ref_case(name, n)
    with _x64_ctx(np.float64):
        ref = ref_race(rc.program, reassociate=rc.reassociate,
                       rewrite_div=rc.rewrite_div)
        want = {k: np.asarray(v) for k, v in ref.run(env, "xla").items()}
    assert {str(v.dtype) for v in want.values()} == {"float64"}
    res = repro_torch.race(pc.program, reassociate=pc.reassociate,
                           rewrite_div=pc.rewrite_div)
    ex = repro_torch.compile_plan(res.plan, env_to_torch(env, "cpu"),
                                  backend)
    assert ex.backend == ("torch" if backend == "torch" else "hopper")
    got = res.run(env, backend, device="cpu")
    assert {k: v.dtype for k, v in got.items()} == {
        k: torch.float64 for k in want}
    tol = default_tolerances(np.float32)["plan"]
    assert rel_err(got, want) <= tol
    batch = res.run_batch([env, env], backend, device="cpu")
    assert {v.dtype for v in batch.values()} == {torch.float64}
    for k in got:
        assert torch.equal(batch[k][1], got[k])
    # without an output array in the env, the operand dtype
    bare = res.run({k: v for k, v in env.items() if k not in outs}, backend,
                   device="cpu")
    assert {v.dtype for v in bare.values()} == {torch.float32}
