"""The port's gradients on the programs behind its faults F14 and F15,
against the reference's at float64 within 1e-10: the reference's
``repro.core.adjoint.backward`` and ``jax.vjp`` of its baseline evaluator.

F14: the autograd fallback raised when an output depends on no wanted
input; F15: a wanted input the program reads, whose adjoint terms all
cancel, got ``None`` where the reference gives zeros.

Each program (``repro_torch.testing.faults``) is built in both packages'
IRs from one function, on one numpy env from a seed.  ``torch.autograd.grad``
runs without ``allow_unused``, so a ``None`` gradient fails as it fails a
user.  The paths: ``res.run``
on ``"torch"``, ``"hopper"`` (the tile emulator) and ``"auto"``,
``run_batch``, ``run_sharded`` on a 2x2 mesh of CPU devices, a
Hessian-vector product against ``jax.grad(jax.grad)``, and a seeded probe
of random 2-D programs."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_case
from repro.core import adjoint as ref_adjoint
from repro.core import ir as rir
from repro.core.race import race as ref_race
from repro.kernels.ref import interior as ref_interior
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import CASES, get_case
from repro_torch.core import adjoint, executor
from repro_torch.core import ir as pir
from repro_torch.core.ir import expr_refs
from repro_torch.launch.mesh import make_stencil_mesh
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch)
from repro_torch.testing.faults import (CANCELLED, FORCED, N, PROGRAMS,
                                       f14_mixed, f14_strided, f14_unit,
                                       f15_scalar)

pytestmark = pytest.mark.port

TOL = 1e-10


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _case(make, dt=np.float64, seed=0, n=N):
    """Both IRs' programs, the env, and the float inputs the program
    reads, sorted."""
    pp, rp = make(pir, n), make(rir, n)
    env = build_env(types.SimpleNamespace(program=pp, scalars=()), dt, seed)
    return pp, rp, env, _read_inputs(pp, env)


def _read_inputs(program, env):
    read = {r.name for st in program.body for r in expr_refs(st.rhs)}
    return sorted(k for k in read
                  if np.issubdtype(np.asarray(env[k]).dtype, np.floating))


def _cotangents(program, dt=np.float64, seed=1, batch=None):
    full = program.ranges()
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    return {st.lhs.name: rng.uniform(-1, 1, lead + tuple(
        full[s.s][1] - full[s.s][0] + 1 for s in st.lhs.subs)).astype(dt)
        for st in program.body}


def _ref_vjp(rp, env, g, backward=True):
    """The reference's VJP at float64: ``jax.vjp`` of its baseline
    evaluator, and (``backward``) its ``adjoint.backward`` (adjoint plans
    on ``"xla"``, or its autodiff fallback), held equal to it."""
    with _x64_ctx(np.float64):
        jenv = {k: jnp.asarray(np.asarray(v, np.float64))
                for k, v in env.items()}
        jg = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in g.items()}
        base = ref_race(rp)
        ev = base.baseline_evaluator()
        vjp = jax.jit(lambda e, c: jax.vjp(
            lambda x: ref_interior(base.plan, ev(x)), e)[1](c)[0])
        want = {k: np.asarray(v) for k, v in vjp(jenv, jg).items()}
        if backward:
            got = ref_adjoint.backward(rp, jenv, jg, backend="xla")
            for k, v in want.items():
                assert _close(np.asarray(got[k]), v), k
    return want


def _close(got, want, tol=TOL):
    """``max |got - want| <= tol * max(1, max |want|)``, in float64."""
    g = np.asarray(got.detach().cpu().double() if hasattr(got, "detach")
                   else got, np.float64)
    w = np.asarray(want, np.float64)
    return g.shape == w.shape and float(np.abs(g - w).max(initial=0.0)) <= (
        tol * max(1.0, float(np.abs(w).max(initial=0.0))))


def _port_grads(res, env, g, wrt, backend, path="run", mesh=None):
    """``torch.autograd.grad`` of the outputs against ``g`` through one
    entry point, without ``allow_unused``: a ``None`` gradient raises."""
    t = {k: torch.tensor(np.asarray(v)) for k, v in env.items()}
    for k in wrt:
        t[k].requires_grad_()
    if path == "run":
        outs = res.run(t, backend, device="cpu")
    elif path == "batch":
        outs = res.run_batch(t, backend, device="cpu")
    else:
        outs = res.run_sharded(t, mesh, backend)
    gs = torch.autograd.grad([outs[k] for k in g], [t[k] for k in wrt],
                             [torch.as_tensor(g[k]) for k in g])
    return dict(zip(wrt, gs)), t


def _assert_cancelled_zeros(got, t, name):
    """Exact zeros of the input's dtype, shape and device."""
    if name in CANCELLED and CANCELLED[name] in got:
        k = CANCELLED[name]
        z = got[k]
        assert (z.dtype, tuple(z.shape), z.device) == (
            t[k].dtype, tuple(t[k].shape), t[k].device)
        assert torch.equal(z, torch.zeros_like(t[k]))


def _subsets(keys):
    return [[k] for k in keys] + ([keys] if len(keys) > 1 else [])


# ---------------------------------------------------------------------------
# res.run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
@pytest.mark.parametrize("wrt", [["A"], ["s0"], ["B"], ["A", "B", "s0"]])
def test_f14_strided_any_subset(wrt, backend):
    """The refused build's fallback with a constant output and an output
    that reads ``B`` alone, for each input alone and all three."""
    pp, rp, env, keys = _case(f14_strided)
    assert adjoint.adjoint_build(pp).reason.startswith(adjoint.STRIDED_READ)
    assert adjoint.adjoint_build(pp).reason == (
        ref_adjoint.adjoint_build(rp).reason)
    assert keys == ["A", "B", "s0"]
    g = _cotangents(pp)
    want = _ref_vjp(rp, env, g)
    res = repro_torch.race(pp, reassociate=3)
    got, _ = _port_grads(res, env, g, wrt, backend)
    for k in wrt:
        assert _close(got[k], want[k]), k


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_f14_mixed_layout_wrt_a(backend):
    """``MIXED_LAYOUT``'s fallback, ``A`` wanted and ``sin(B)`` not; the
    forward plan cannot take the kernel, so ``"auto"`` runs it on
    ``"torch"``."""
    pp, rp, env, _ = _case(f14_mixed)
    assert adjoint.adjoint_build(pp).reason.startswith(adjoint.MIXED_LAYOUT)
    assert adjoint.adjoint_build(pp).reason == (
        ref_adjoint.adjoint_build(rp).reason)
    g = _cotangents(pp)
    want = _ref_vjp(rp, env, g)
    res = repro_torch.race(pp, reassociate=3)
    got, _ = _port_grads(res, env, g, ["A"], backend)
    assert _close(got["A"], want["A"])


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
@pytest.mark.parametrize("wrt", [["A"], ["B"]])
def test_f14_unit_twin_forced_autodiff(wrt, backend, monkeypatch):
    """The unit-stride twin builds its adjoint; forced onto the fallback it
    gives the same gradients as the stencil path."""
    monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    pp, rp, env, _ = _case(f14_unit)
    g = _cotangents(pp)
    want = _ref_vjp(rp, env, g)
    res = repro_torch.race(pp, reassociate=3)
    got, _ = _port_grads(res, env, g, wrt, backend)
    for k in wrt:
        assert _close(got[k], want[k]), k
    monkeypatch.delenv("RACE_ADJOINT")
    stencil, _ = _port_grads(res, env, g, wrt, backend)
    for k in wrt:
        assert _close(stencil[k], want[k]), k


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
@pytest.mark.parametrize("lvl", [0, 3, 4])
@pytest.mark.parametrize("name", ["f15_sin", "f15_scalar"])
def test_f15_cancelled_input_gets_zeros(name, lvl, backend):
    """Each input alone and all of them: the cancelled one gets exact
    zeros, the others the reference's gradient; the build, as the
    reference's, has no spec for the cancelled input."""
    pp, rp, env, keys = _case(PROGRAMS[name])
    build = adjoint.adjoint_build(pp)
    assert build.ok and build.spec_for(CANCELLED[name]) is None
    assert [s.input for s in build.specs] == [
        s.input for s in ref_adjoint.adjoint_build(rp).specs]
    g = _cotangents(pp)
    want = _ref_vjp(rp, env, g)
    res = repro_torch.race(pp, reassociate=lvl)
    for wrt in _subsets(keys):
        got, t = _port_grads(res, env, g, wrt, backend)
        for k in wrt:
            assert _close(got[k], want[k]), (wrt, k)
        _assert_cancelled_zeros(got, t, name)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("dt", [np.float32, np.float16])
@pytest.mark.parametrize("name", ["f15_sin", "f15_scalar"])
def test_f15_zeros_keep_the_dtype(name, dt, backend):
    """At float32 and float16 the cancelled input's zeros take its dtype;
    the other inputs are within the dtype's ``grad`` tolerance of the
    float64 reference on the same (rounded) values."""
    pp, rp, env, keys = _case(PROGRAMS[name], dt)
    g = _cotangents(pp, dt)
    want = _ref_vjp(rp, env, g, backward=False)
    res = repro_torch.race(pp, reassociate=3)
    got, t = _port_grads(res, env, g, keys, backend)
    assert {k: v.dtype for k, v in got.items()} == {
        k: t[k].dtype for k in keys}
    _assert_cancelled_zeros(got, t, name)
    tol = default_tolerances(dt)["grad"]
    for k in keys:
        assert _close(got[k], want[k], tol), k


def test_backward_fills_only_wanted_read_float_inputs():
    """``adjoint.backward`` itself: zeros for the cancelled input, ``None``
    for the unread output arrays in the env, for an integer input, and for
    inputs not wanted (F2)."""
    pp, _, env, _ = _case(f15_scalar)
    tenv = {k: torch.tensor(np.asarray(v)) for k, v in env.items()}
    tenv["s1"] = torch.tensor(2)  # an integer input the program never reads
    g = {k: torch.as_tensor(v) for k, v in _cotangents(pp).items()}
    grads = adjoint.backward(pp, tenv, g, wrt=["s0", "s1", "out0"])
    assert set(grads) == set(tenv)
    assert torch.equal(grads["s0"], torch.zeros((), dtype=torch.float64))
    assert [k for k, v in grads.items() if v is not None] == ["s0"]
    grads = adjoint.backward(pp, tenv, g)
    assert sorted(k for k, v in grads.items() if v is not None) == [
        "A", "B", "s0"]


@pytest.mark.parametrize("name", CASES)
def test_registry_partial_wrt(name):
    """Every registry case with each read input wanted alone, through
    ``adjoint.backward`` on ``"torch"`` (rprj3 and diag2d through the
    fallback): that input's gradient within 1e-10 of the reference's VJP,
    every other entry ``None``."""
    n = SWEEP_SIZES[name]
    pc = get_case(name, n)
    env = build_env(pc, np.float64, seed=3)
    g = _cotangents(pc.program)
    want = _ref_vjp(ref_case(name, n).program, env, g, backward=False)
    tenv, tg = env_to_torch(env, "cpu"), env_to_torch(g, "cpu")
    for k in _read_inputs(pc.program, env):
        got = adjoint.backward(pc.program, tenv, tg, backend="torch",
                               wrt=[k])
        assert [j for j, v in got.items() if v is not None] == [k]
        assert _close(got[k], want[k]), k


# ---------------------------------------------------------------------------
# run_batch and run_sharded
# ---------------------------------------------------------------------------

#: (program, level, wanted inputs) for the batched and sharded paths
PATH_CASES = [("f14_strided", 3, ["A"]), ("f14_strided", 3, ["s0"]),
              ("f14_unit", 3, ["A"]), ("f15_sin", 0, ["B"]),
              ("f15_sin", 0, ["A", "B"]), ("f15_scalar", 3, ["s0"]),
              ("f15_scalar", 4, ["A", "B", "s0"])]


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,lvl,wrt", PATH_CASES)
def test_run_batch(name, lvl, wrt, backend, monkeypatch):
    """B = 3 examples from three seeds, against the reference's VJP of
    each."""
    if name in FORCED:
        monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    make = PROGRAMS[name]
    cases = [_case(make, seed=s) for s in range(3)]
    pp, rp = cases[0][:2]
    env = {k: np.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    g = _cotangents(pp, batch=3)
    res = repro_torch.race(pp, reassociate=lvl)
    got, t = _port_grads(res, env, g, wrt, backend, "batch")
    _assert_cancelled_zeros(got, t, name)
    for b, c in enumerate(cases):
        want = _ref_vjp(rp, c[2], {k: v[b] for k, v in g.items()},
                        backward=False)
        for k in wrt:
            assert _close(got[k][b], want[k]), (b, k)


@pytest.fixture(scope="module")
def mesh():
    return make_stencil_mesh(4, devices=["cpu"] * 4)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,lvl,wrt", PATH_CASES)
def test_run_sharded(name, lvl, wrt, backend, mesh, monkeypatch):
    """On a 2x2 mesh of CPU devices (8x8 boxes split 4x4)."""
    if name in FORCED:
        monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    pp, rp, env, _ = _case(PROGRAMS[name])
    g = _cotangents(pp)
    want = _ref_vjp(rp, env, g, backward=False)
    res = repro_torch.race(pp, reassociate=lvl)
    got, t = _port_grads(res, env, g, wrt, backend, "sharded", mesh)
    _assert_cancelled_zeros(got, t, name)
    for k in wrt:
        assert _close(got[k], want[k]), k


# ---------------------------------------------------------------------------
# second order
# ---------------------------------------------------------------------------


def _weights(shape, k):
    n = int(np.prod(shape))
    return np.cos(np.arange(n) + 0.7 * k).reshape(shape)


def _ref_hvp(rp, lvl, env, keys, v):
    with _x64_ctx(np.float64):
        res = ref_race(rp, reassociate=lvl)

        def f(p):
            outs = res.run({**env, **p}, "xla")
            return sum(jnp.sum(jnp.asarray(_weights(outs[nm].shape, k))
                               * outs[nm] ** 2)
                       for k, nm in enumerate(sorted(outs)))

        def gv(p):
            g = jax.grad(f)(p)
            return sum(jnp.vdot(g[k], jnp.asarray(v[k])) for k in keys)

        hv = jax.grad(gv)({k: jnp.asarray(env[k]) for k in keys})
        return {k: np.asarray(x) for k, x in hv.items()}


@pytest.mark.parametrize("path", ["run", "sharded"])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,lvl", [("f15_sin", 0), ("f15_scalar", 3),
                                      ("f15_scalar", 4)])
def test_f15_hvp_matches_reference(name, lvl, backend, path, mesh):
    """A Hessian-vector product through the first backward's recorded
    graph: the cancelled input's zeros stay differentiable, and its block
    of the product is exact zeros, as ``jax.grad(jax.grad)`` gives it."""
    pp, rp, env, keys = _case(PROGRAMS[name])
    rng = np.random.default_rng(7)
    v = {k: rng.standard_normal(np.shape(env[k])) for k in keys}
    res = repro_torch.race(pp, reassociate=lvl)
    p = {k: torch.tensor(np.asarray(env[k])).requires_grad_() for k in keys}
    t = {**{k: torch.tensor(np.asarray(x)) for k, x in env.items()}, **p}
    outs = (res.run(t, backend, device="cpu") if path == "run"
            else res.run_sharded(t, mesh, backend))
    f = sum((torch.as_tensor(_weights(tuple(outs[nm].shape), k))
             * outs[nm] ** 2).sum() for k, nm in enumerate(sorted(outs)))
    g = torch.autograd.grad(f, [p[k] for k in keys], create_graph=True)
    hv = dict(zip(keys, torch.autograd.grad(
        g, [p[k] for k in keys], [torch.as_tensor(v[k]) for k in keys])))
    want = _ref_hvp(rp, lvl, env, keys, v)
    c = CANCELLED[name]
    assert torch.equal(hv[c], torch.zeros_like(p[c]))
    assert np.all(want[c] == 0)
    for k in keys:
        assert _close(hv[k], want[k]), k


# ---------------------------------------------------------------------------
# a seeded probe of random programs
# ---------------------------------------------------------------------------


def random_program(ir, rng):
    """One to three statements over ``A``, ``B``, ``C`` (offsets -1..1 on
    an interior box) and the scalar ``s0``, with ``+ - *``, ``sin``,
    constants, and cancelling differences ``e - e``."""
    loops, (i, j) = ir.loopnest(("i", 1, 6), ("j", 1, 6))
    arrays = {nm: ir.arr(nm) for nm in "ABC"}

    def leaf():
        r = rng.random()
        if r < 0.15:
            return ir.Scalar("s0")
        if r < 0.25:
            return float(rng.choice([0.5, 2.0, 0.3]))
        nm = "ABC"[int(rng.integers(3))]
        return arrays[nm][i + int(rng.integers(-1, 2)),
                          j + int(rng.integers(-1, 2))]

    def expr(depth):
        if depth == 0 or rng.random() < 0.3:
            return leaf()
        r = rng.random()
        if r < 0.2:
            e = expr(depth - 1)
            return e - e
        if r < 0.3:
            return ir.sin(expr(depth - 1))
        a, b = expr(depth - 1), expr(depth - 1)
        op = int(rng.integers(3))
        return a + b if op == 0 else a - b if op == 1 else a * b

    n_st = int(rng.integers(1, 4))
    body = [(ir.arr(f"out{k}")[i, j], expr(3)) for k in range(n_st)]
    # one read of an array, so that some input is read
    body[0] = (body[0][0], body[0][1] + arrays["A"][i, j])
    return ir.program(loops, body)


@pytest.mark.parametrize("seed", range(40))
def test_random_program_probe(seed, monkeypatch):
    """A random subset of the read inputs wanted, at a random level of
    {0, 3, 4}, on ``"torch"`` or ``"auto"``, a quarter of them on the
    forced fallback; every wanted gradient within 1e-10 of the
    reference's VJP, none ``None``."""
    rng = np.random.default_rng(1000 + seed)
    lvl = int(rng.choice([0, 3, 4]))
    backend = ["torch", "auto"][int(rng.integers(2))]
    if rng.random() < 0.25:
        monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    pseed = int(rng.integers(1 << 30))
    pp = random_program(pir, np.random.default_rng(pseed))
    rp = random_program(rir, np.random.default_rng(pseed))
    env = build_env(types.SimpleNamespace(program=pp, scalars=()),
                    np.float64, seed)
    keys = _read_inputs(pp, env)
    wrt = [k for k in keys if rng.random() < 0.5] or [keys[0]]
    g = _cotangents(pp, seed=seed)
    want = _ref_vjp(rp, env, g, backward=False)
    res = repro_torch.race(pp, reassociate=lvl)
    got, _ = _port_grads(res, env, g, wrt, backend)
    for k in wrt:
        assert _close(got[k], want[k]), k
