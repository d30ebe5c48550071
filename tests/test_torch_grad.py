"""The port's gradient path against the reference's: ``torch.autograd.grad``
through ``res.run`` equal to ``jax.grad`` through the reference's
``res.run(env, "xla")`` at the harness's ``grad`` tolerance, on the
``"torch"`` backend and on ``"hopper"`` (its tile emulator on the CPU), the
refused adjoints' fallback, and the autograd wrapper's plumbing (executor
cache, ``None`` gradients, knobs, no wrapper without ``requires_grad``).
The adjoint construction itself is held in ``test_torch_adjoint.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import adjoint, executor
from repro_torch.core.codegen import build_baseline_evaluator, interior
from repro_torch.testing import (build_env, coverage_matrix,
                                 default_tolerances, env_to_torch,
                                 grad_sweep_registry, rel_err, run_grad_case)

pytestmark = pytest.mark.port

SLICE = [("psinv", 8), ("resid", 8), ("diffusion3", 8), ("smooth1d", 20),
         ("mirror_deriv", 12)]


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _float_keys(env):
    return sorted(k for k, v in env.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating))


def _weights(n):
    return np.cos(np.arange(n))


_REF_GRADS: dict = {}


def _ref_grads(rc, lvl, env, keys, dt):
    """``jax.grad`` of the cosine-projection loss through the reference's
    ``res.run(env, "xla")``, once per case and level (the tests of both
    port backends share it)."""
    key = (rc.name, rc.program.ranges()[1], lvl, np.dtype(dt).name)
    if key not in _REF_GRADS:
        _REF_GRADS[key] = _ref_grads_uncached(rc, lvl, env, keys, dt)
    return _REF_GRADS[key]


def _ref_grads_uncached(rc, lvl, env, keys, dt):
    with _x64_ctx(dt):
        res = ref_race(rc.program, reassociate=lvl,
                       rewrite_div=rc.rewrite_div)

        def loss(p):
            outs = res.run({**env, **p}, "xla")
            return sum(jnp.sum(jnp.asarray(v) * jnp.asarray(
                _weights(v.size).reshape(v.shape), v.dtype))
                for v in outs.values())

        g = jax.grad(loss)({k: jnp.asarray(env[k]) for k in keys})
        return {k: np.asarray(v) for k, v in g.items()}


def _port_grads(res, env, keys, backend):
    p = {k: torch.tensor(np.asarray(env[k])).requires_grad_() for k in keys}
    outs = res.run({**env, **p}, backend, device="cpu")
    loss = sum((v * torch.as_tensor(_weights(v.numel()).reshape(
        tuple(v.shape)), dtype=v.dtype)).sum() for v in outs.values())
    gs = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(p[k]) if g is None else g
            for k, g in zip(keys, gs)}


# ---------------------------------------------------------------------------
# gradients through res.run against jax.grad through the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("lvl", [0, 3, 4])
@pytest.mark.parametrize("name,n", SLICE)
def test_grad_matches_reference(name, n, lvl, backend):
    rc, pc = ref_case(name, n), get_case(name, n)
    env = build_env(pc)
    keys = _float_keys(env)
    want = _ref_grads(rc, lvl, env, keys, np.float32)
    res = repro_torch.race(pc.program, reassociate=lvl,
                           rewrite_div=pc.rewrite_div)
    assert res.select_backend(backend).backend == backend
    got = _port_grads(res, env, keys, backend)
    assert adjoint.adjoint_build(pc.program).ok
    assert rel_err(got, want) <= default_tolerances(np.float32)["grad"]


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,n,code", [
    ("rprj3", 10, adjoint.STRIDED_READ), ("diag2d", 12,
                                          adjoint.REPEATED_LEVEL)])
def test_grad_fallback_cases_match_reference(name, n, code, backend):
    """The adjoint detector refuses these with a code and the backward falls
    back to autograd of the baseline; the gradients still match."""
    rc, pc = ref_case(name, n), get_case(name, n)
    env = build_env(pc)
    keys = _float_keys(env)
    res = repro_torch.race(pc.program, reassociate=3)
    got = _port_grads(res, env, keys, backend)
    want = _ref_grads(rc, 3, env, keys, np.float32)
    assert rel_err(got, want) <= default_tolerances(np.float32)["grad"]
    report = run_grad_case(pc, reassociate_levels=(0, 3), device="cpu")
    assert not report.failures()
    assert all(c.reason.startswith(f"adjoint-autodiff: {code}")
               for c in report.combos)


@pytest.mark.parametrize("name,n", SLICE)
def test_run_grad_case_against_float64_baseline(name, n):
    report = run_grad_case(get_case(name, n), device="cpu")
    assert not report.failures(), [(c.reassociate, c.backend, c.reason)
                                   for c in report.failures()]
    assert len(report.combos) == 6 and all(c.ok for c in report.combos)


def test_grad_sweep_registry_matrix_names_the_fallbacks():
    reports = grad_sweep_registry(["smooth1d", "diag2d"],
                                  reassociate_levels=(3,), device="cpu")
    assert not [f for r in reports for f in r.failures()]
    matrix = coverage_matrix(reports)
    assert "r3/hopper" in matrix and "r3/torch" in matrix
    assert "REPEATED_LEVEL" not in matrix.splitlines()[1]
    assert all(c.reason.startswith("adjoint-autodiff: REPEATED_LEVEL")
               for c in reports[1].combos)


# ---------------------------------------------------------------------------
# the autograd wrapper's plumbing
# ---------------------------------------------------------------------------


def _psinv():
    case = get_case("psinv", 8)
    return case, repro_torch.race(case.program, reassociate=3)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_adjoint_plans_hit_the_executor_cache_on_second_step(backend):
    case, res = _psinv()
    env = build_env(case)
    keys = _float_keys(env)
    cache = executor.executor_cache()
    g1 = _port_grads(res, env, keys, backend)
    mid = cache.stats_snapshot()
    cached = {k.plan for k in cache.keys()}
    build = adjoint.adjoint_build(case.program)
    adj = {repro_torch.plan_hash(s.result().plan) for s in build.specs}
    fwd = repro_torch.plan_hash(res.plan)
    assert fwd in cached and adj <= cached and fwd not in adj
    spec = build.spec_for("R")
    assert spec.result().reduced_ops() > 0
    assert spec.gu.startswith(adjoint.ADJOINT_PREFIX)
    g2 = _port_grads(res, env, keys, backend)
    after = cache.stats_snapshot()
    assert after["misses"] == mid["misses"]
    assert after["hits"] >= mid["hits"] + 1 + len(build.specs)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_unread_and_integer_inputs_get_none():
    """An output array handed in the env is not read, and an integer
    scalar has no gradient: both come back as ``None``."""
    case = get_case("j3d27pt", 8)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case), "cpu")
    env["jc0"] = torch.tensor(1)  # an integer coefficient
    out = interior(res.plan, build_baseline_evaluator(case.program)(env))
    g = {k: torch.ones_like(v) for k, v in out.items()}
    grads = adjoint.backward(case.program, env, g)
    assert set(grads) == set(env)
    assert grads["jc0"] is None
    assert "j27" in env and grads["j27"] is None  # the output, never read
    assert all(tuple(grads[k].shape) == tuple(env[k].shape)
               for k in ("u", "jc1", "jnorm"))
    p = env["u"].clone().requires_grad_()
    got = res.run({**env, "u": p}, "torch", device="cpu")
    (gu,) = torch.autograd.grad(sum(v.sum() for v in got.values()), [p])
    assert torch.allclose(gu, grads["u"], rtol=1e-6, atol=1e-6)


def test_backward_computes_only_the_inputs_asked_for():
    case, res = _psinv()
    env = env_to_torch(build_env(case), "cpu")
    out = res.run(env, "torch", device="cpu")
    g = {k: torch.ones_like(v) for k, v in out.items()}
    grads = adjoint.backward(case.program, env, g, wrt=["R"])
    assert grads["R"] is not None
    assert all(v is None for k, v in grads.items() if k != "R")


def test_adjoint_env_knobs(monkeypatch):
    assert adjoint.adjoint_mode() == "stencil"
    assert adjoint.adjoint_reassociate() == 3
    monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    assert adjoint.adjoint_mode() == "autodiff"
    monkeypatch.setenv("RACE_ADJOINT", "nonsense")
    with pytest.raises(ValueError, match="RACE_ADJOINT"):
        adjoint.adjoint_mode()
    monkeypatch.delenv("RACE_ADJOINT")
    monkeypatch.setenv("RACE_ADJOINT_REASSOCIATE", "x")
    with pytest.raises(ValueError, match="RACE_ADJOINT_REASSOCIATE"):
        adjoint.adjoint_reassociate()
    monkeypatch.setenv("RACE_ADJOINT_REASSOCIATE", "0")
    assert adjoint.adjoint_reassociate() == 0

    case = get_case("smooth1d", 16)
    env = build_env(case)
    res = repro_torch.race(case.program, reassociate=3)
    g_r0 = _port_grads(res, env, ["ws"], "torch")["ws"]
    spec = adjoint.adjoint_build(case.program).spec_for("ws")
    r0_plan = repro_torch.plan_hash(spec.result().plan)
    monkeypatch.delenv("RACE_ADJOINT_REASSOCIATE")
    g_r3 = _port_grads(res, env, ["ws"], "torch")["ws"]
    assert repro_torch.plan_hash(spec.result().plan) != r0_plan
    monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    g_auto = _port_grads(res, env, ["ws"], "torch")["ws"]
    tol = default_tolerances(np.float32)["grad"]
    assert rel_err({"ws": g_r0}, {"ws": g_r3}) <= tol
    assert rel_err({"ws": g_auto}, {"ws": g_r3}) <= tol


def test_no_autograd_wrapper_without_requires_grad(monkeypatch):
    """Without an input that requires grad, or under ``no_grad``, a run
    calls the bare core: no graph, no autograd node."""
    case, res = _psinv()
    env = env_to_torch(build_env(case), "cpu")

    def refuse(*a, **k):
        raise AssertionError("autograd wrapper used")

    monkeypatch.setattr(executor._RaceFunction, "apply", refuse)
    ex = repro_torch.compile_plan(res.plan, env, "hopper")
    calls, launches = ex.calls, ex.kernel_launches
    out = res.run(env, "hopper", device="cpu")
    assert all(v.grad_fn is None and not v.requires_grad
               for v in out.values())
    p = env["R"].clone().requires_grad_()
    with torch.no_grad():
        out = res.run({**env, "R": p}, "hopper", device="cpu")
    assert all(v.grad_fn is None for v in out.values())
    assert ex.calls == calls + 2 and ex.kernel_launches == launches


def test_run_with_requires_grad_returns_equal_values():
    case, res = _psinv()
    env = env_to_torch(build_env(case), "cpu")
    plain = res.run(env, "torch", device="cpu")
    p = env["R"].clone().requires_grad_()
    out = res.run({**env, "R": p}, "torch", device="cpu")
    assert sorted(out) == sorted(plain)
    for k in plain:
        assert out[k].grad_fn is not None
        assert torch.equal(out[k].detach(), plain[k])


def test_env_to_torch_keeps_the_autograd_graph():
    """A non-leaf, non-contiguous input keeps its graph through
    ``env_to_torch``, and the gradient reaches the leaf."""
    case, res = _psinv()
    env = env_to_torch(build_env(case), "cpu")
    leaf = env["R"].permute(2, 1, 0).contiguous().requires_grad_()
    r = leaf.permute(2, 1, 0)
    assert not r.is_contiguous() and r.grad_fn is not None
    moved = env_to_torch({"R": r}, "cpu")["R"]
    assert moved.grad_fn is not None and moved.is_contiguous()
    out = res.run({**env, "R": r}, "torch", device="cpu")
    (g,) = torch.autograd.grad(sum(v.sum() for v in out.values()), [leaf])
    out0 = res.run({**env, "R": env["R"].clone().requires_grad_()}, "torch",
                   device="cpu")
    assert g.abs().sum() > 0 and tuple(g.shape) == tuple(leaf.shape)
    assert all(v.grad_fn is not None for v in out0.values())
