"""Second-order gradients through the PyTorch port against the reference's:
Hessian-vector products of a weighted sum of squared outputs, taken as
``torch.autograd.grad`` of ``torch.autograd.grad(..., create_graph=True)``
through ``res.run``, against ``jax.grad`` of ``jax.grad`` through the
reference's ``res.run(env, "xla")`` at the float64 ``grad`` tolerance, on
every registry case and both port backends (rprj3 and diag2d through the
refused specs' autograd fallback).  The first backward's adjoint runs are
autograd nodes themselves; a first-order backward still runs them bare."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import CASES, get_case
from repro_torch.core import adjoint, executor
from repro_torch.core.ir import expr_refs
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)

pytestmark = pytest.mark.port

#: grid sizes: the sweep's, smaller for the 3-D cases (jit of the
#: reference's double backward dominates; the adjoint programs stay whole)
SIZES = {nm: min(n, 8) for nm, n in SWEEP_SIZES.items()}
SIZES.update(smooth1d=24, blocked4d=6)


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _setup(name, dt=np.float64):
    """Case, env and the float inputs the program reads (an output array
    read pointwise, as psinv's ``U``, is one), with a direction each."""
    n = SIZES[name]
    pc = get_case(name, n)
    read = {r.name for st in pc.program.body for r in expr_refs(st.rhs)}
    env = {k: v for k, v in build_env(pc, dt).items() if k in read}
    keys = sorted(k for k, v in env.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating))
    rng = np.random.default_rng(7)
    v = {k: rng.standard_normal(np.shape(env[k])).astype(dt) for k in keys}
    return pc, ref_case(name, n), env, keys, v


def _weights(shape, dt, k):
    """Weights of the ``k``-th output: another phase per output, so that no
    input drops out of the loss by symmetry (ocn_export's ``ue**2 + vn**2``
    does not depend on ``ang``)."""
    n = int(np.prod(shape))
    return np.cos(np.arange(n) + 0.7 * k).reshape(shape).astype(dt)


_REF_HVP: dict = {}


def _ref_hvp(rc, env, keys, v, dt):
    """The reference's product, once per case (both port backends share
    it)."""
    if rc.name not in _REF_HVP:
        _REF_HVP[rc.name] = _ref_hvp_uncached(rc, env, keys, v, dt)
    return _REF_HVP[rc.name]


def _ref_hvp_uncached(rc, env, keys, v, dt):
    with _x64_ctx(dt):
        res = ref_race(rc.program, reassociate=rc.reassociate,
                       rewrite_div=rc.rewrite_div)

        def f(p):
            outs = res.run({**env, **p}, "xla")
            return sum(jnp.sum(jnp.asarray(_weights(outs[nm].shape, dt, k))
                               * outs[nm] ** 2)
                       for k, nm in enumerate(sorted(outs)))

        def gv(p):
            g = jax.grad(f)(p)
            return sum(jnp.vdot(g[k], jnp.asarray(v[k])) for k in keys)

        hv = jax.grad(gv)({k: jnp.asarray(env[k]) for k in keys})
        return {k: np.asarray(x) for k, x in hv.items()}


def _port_hvp(res, env, keys, v, backend, dt):
    p = {k: torch.tensor(np.asarray(env[k])).requires_grad_() for k in keys}
    outs = res.run({**env, **p}, backend, device="cpu")
    f = sum((torch.as_tensor(_weights(tuple(outs[nm].shape), dt, k))
             * outs[nm] ** 2).sum() for k, nm in enumerate(sorted(outs)))
    g = torch.autograd.grad(f, [p[k] for k in keys], create_graph=True)
    hv = torch.autograd.grad(g, [p[k] for k in keys],
                             [torch.as_tensor(v[k]) for k in keys],
                             allow_unused=True)
    return dict(zip(keys, hv))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name", CASES)
def test_hvp_matches_reference(name, backend, monkeypatch):
    """The product within ``grad`` of the reference's, no ``None``; where
    the forward's adjoint builds, the whole second backward runs adjoint
    plans (the adjoint of each adjoint included) on the default backend,
    which takes the kernel for each, and never the autograd fallback."""
    pc, rc, env, keys, v = _setup(name)
    res = repro_torch.race(pc.program, reassociate=pc.reassociate,
                           rewrite_div=pc.rewrite_div)
    assert res.select_backend(backend).backend == backend
    fallback = []
    autodiff = adjoint._autodiff_backward
    monkeypatch.setattr(adjoint, "_autodiff_backward",
                        lambda *a: fallback.append(a[0]) or autodiff(*a))
    got = _port_hvp(res, env, keys, v, backend, np.float64)
    assert [k for k, x in got.items() if x is None] == []
    want = _ref_hvp(rc, env, keys, v, np.float64)
    assert rel_err(got, want) <= default_tolerances(np.float64)["grad"]
    if name in ("rprj3", "diag2d"):  # the autograd fallback kept the graph
        assert not adjoint.adjoint_build(pc.program).ok
        assert fallback
    else:
        assert fallback == []
        assert {ex.backend for ex in executor.executor_cache().executors()
                if ex.plan is not res.plan} == {"hopper"}


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in ("rprj3", "diag2d")])
def test_every_adjoint_program_has_an_adjoint(name):
    """Second order stays on the stencil path: each adjoint program the
    forward builds builds its own adjoints (its ``_g_``/``_adj_`` names
    are not refused), and those take the Hopper kernel."""
    program = get_case(name, SIZES[name]).program
    for spec in adjoint.adjoint_build(program).specs:
        build = adjoint.adjoint_build(spec.program)
        assert build.ok, (spec.input, build.reason)
        assert build.specs
        for s in build.specs:
            assert repro_torch.probe_hopper(s.result().plan,
                                            ["float32"]).eligible


def _renamed(program, old, new):
    from repro_torch.core.ir import Program, Ref, Stmt, map_expr

    def fn(x):
        return Ref(new, x.subs) if isinstance(x, Ref) and x.name == old \
            else x

    return Program(program.loops, tuple(Stmt(st.lhs, map_expr(st.rhs, fn))
                                        for st in program.body))


@pytest.mark.parametrize("new,ok", [("_g_sm1", False), ("_adj_ws", False),
                                    ("_g_u", True), ("_adj_u", True)])
def test_adjoint_refuses_only_names_it_would_make(new, ok):
    """smooth1d's array ``u`` renamed: the adjoint refuses a name it would
    make itself (the cotangent of output ``sm1``, the accumulator of input
    ``ws``) with ``LHS_FORM``, and takes any other name with a reserved
    prefix as an input array."""
    program = _renamed(get_case("smooth1d", 12).program, "u", new)
    build = adjoint.adjoint_build(program)
    if not ok:
        assert build.reason.startswith(adjoint.LHS_FORM)
        return
    assert build.ok
    feeds = {(kind, src) for s in build.specs for kind, src, _, _ in s.feeds}
    assert ("array", new) in feeds and ("cotangent", "sm1") in feeds


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_smooth1d_second_derivative_probe(backend):
    """``f(u) = sum(run(u)**2)`` on smooth1d (n = 24, float32): the sum of
    ``H @ 1`` is the reference's 816.42 (not ``None``)."""
    pc, rc, env, _, _ = _setup("smooth1d", np.float32)
    res = repro_torch.race(pc.program, reassociate=pc.reassociate)
    u = torch.tensor(env["u"]).requires_grad_()
    out = res.run({**env, "u": u}, backend, device="cpu")
    (g,) = torch.autograd.grad(sum((o * o).sum() for o in out.values()), u,
                               create_graph=True)
    (h,) = torch.autograd.grad(g, u, torch.ones_like(u), allow_unused=True)
    assert h is not None
    ref = ref_race(rc.program, reassociate=rc.reassociate)

    def f(x):
        return sum(jnp.sum(o * o) for o in ref.run({**env, "u": x},
                                                   "xla").values())

    want = float(jnp.sum(jax.grad(lambda x: jnp.vdot(
        jax.grad(f)(x), jnp.ones_like(x)))(jnp.asarray(env["u"]))))
    assert want == pytest.approx(816.42, rel=1e-5)
    tol = default_tolerances(np.float32)["grad"]
    assert float(h.sum()) == pytest.approx(want, rel=tol)


def _count_nodes(monkeypatch) -> list:
    calls = []
    apply = executor._RaceFunction.apply

    def counting(ex, names, batched, *tensors):
        calls.append(ex)
        return apply(ex, names, batched, *tensors)

    monkeypatch.setattr(executor._RaceFunction, "apply", counting)
    return calls


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_first_order_backward_runs_adjoints_bare(monkeypatch, backend):
    """A plain backward runs each adjoint plan once, bare (no autograd node
    of its own), as before second order existed; under ``create_graph``
    each adjoint run is a node."""
    case = get_case("psinv", 8)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case), "cpu")
    keys = ["R", "U"]
    calls = _count_nodes(monkeypatch)
    for create in (False, True):
        calls.clear()
        p = {k: env[k].clone().requires_grad_() for k in keys}
        out = res.run({**env, **p}, backend, device="cpu")
        specs = [s for s in adjoint.adjoint_build(case.program).specs
                 if s.input in keys]
        # the backward's executors: under create_graph the cotangent
        # requires grad, and the adjoint plans read its canvas
        g = {k: torch.ones_like(v).requires_grad_(create)
             for k, v in out.items()}
        adj = [adjoint.adjoint_executor(s, env, g) for s in specs]
        before = [ex.calls for ex in adj]
        grads = torch.autograd.grad((out["U"] ** 2).sum(),
                                    [p[k] for k in keys], create_graph=create)
        assert all(g is not None for g in grads)
        assert [ex.calls - b for ex, b in zip(adj, before)] == [1] * len(adj)
        assert len(calls) == (1 + len(adj) if create else 1)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_hvp_through_run_batch_equals_per_example(backend):
    """Second order through ``run_batch``: the batched adjoint runs are
    nodes whose backward runs batched again."""
    pc, _, env, keys, v = _setup("j3d27pt")
    res = repro_torch.race(pc.program, reassociate=pc.reassociate)
    envs = [env, {k: (x * 0.5 if k == "u" else x) for k, x in env.items()}]
    p = {k: torch.stack([torch.as_tensor(e[k]) for e in envs])
         .requires_grad_() for k in keys}
    out = res.run_batch(p, backend, device="cpu")
    f = sum((o * o).sum() for o in out.values())
    g = torch.autograd.grad(f, [p[k] for k in keys], create_graph=True)
    vb = [torch.stack([torch.as_tensor(v[k])] * 2) for k in keys]
    hb = dict(zip(keys, torch.autograd.grad(g, [p[k] for k in keys], vb)))
    for b, e in enumerate(envs):
        q = {k: torch.as_tensor(e[k]).clone().requires_grad_() for k in keys}
        o = res.run(q, backend, device="cpu")
        gs = torch.autograd.grad(sum((x * x).sum() for x in o.values()),
                                 [q[k] for k in keys], create_graph=True)
        hs = torch.autograd.grad(gs, [q[k] for k in keys],
                                 [torch.as_tensor(v[k]) for k in keys])
        for k, h in zip(keys, hs):
            assert rel_err({k: hb[k][b]}, {k: h}) <= 1e-12, (k, b)
