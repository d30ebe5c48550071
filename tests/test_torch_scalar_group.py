"""A program's scalar adjoints run as one adjoint program, the scalar group
(``repro_torch/core/adjoint.py: ScalarGroup``): one statement per wanted
scalar over the forward's whole box, fed by one pad pass, run through
``run_sum`` (on ``"hopper"`` one summed march: here the kernel's tile
emulator).  Held against the reference's VJP and against the per-spec path;
the runs a backward makes are counted on ``LoweredStencil``; the group's
program and plan are the reference ``race``'s on the same statements."""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_case
from repro.core import adjoint as ref_adjoint
from repro.core import ir as ref_ir
from repro.core.executor import program_hash as ref_program_hash
from repro.core.race import race as ref_race
from repro.kernels.ref import interior as ref_interior
from repro.models import ssm as ref_ssm
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import adjoint, executor
from repro_torch.core.ir import expr_refs
from repro_torch.lowering.emit import LoweredStencil
from repro_torch.models import ssm
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)
from test_torch_hvp import _port_hvp, _ref_hvp_uncached
from test_torch_seed import ROOT, _env

pytestmark = pytest.mark.port

#: the registry's cases with two or more scalar adjoint specs
GROUP_CASES = ["derivative", "gaussian", "j3d27pt", "mirror_deriv", "poisson",
               "psinv", "resid"]


@pytest.fixture
def runs(monkeypatch):
    """Counts of the kernel wrapper's calls: ``apply`` (one run of an array
    spec) and ``apply_sum`` (one summed run), each with the names of the
    outputs it gave.  The executor cache is cleared so that every executor
    binds the counting ``apply``."""
    calls = {"apply": [], "apply_sum": []}
    for name in calls:
        orig = getattr(LoweredStencil, name)

        def counting(self, env, *a, _orig=orig, _name=name, **kw):
            out = _orig(self, env, *a, **kw)
            calls[_name].append(sorted(out))
            return out

        monkeypatch.setattr(LoweredStencil, name, counting)
    executor.executor_cache().clear()
    yield calls
    executor.executor_cache().clear()


def _setup(name, dt):
    """Case pair, numpy env (float32 values, in ``dt``), the float inputs
    the program reads, and the cotangents (``cos`` weights, one phase per
    output) as numpy arrays."""
    n = SWEEP_SIZES[name]
    pc, rc = get_case(name, n), ref_case(name, n)
    read = {r.name for st in pc.program.body for r in expr_refs(st.rhs)}
    env = {k: np.asarray(v).astype(dt) if np.issubdtype(
        np.asarray(v).dtype, np.floating) else v
        for k, v in build_env(pc, np.float32, seed=2).items()}
    keys = sorted(k for k in read
                  if np.issubdtype(np.asarray(env[k]).dtype, np.floating))
    res = repro_torch.race(pc.program)
    outs = res.run(env_to_torch(env, "cpu"), "torch", device="cpu")
    g = {nm: np.cos(np.arange(v.numel()) + 0.7 * k).reshape(
        tuple(v.shape)).astype(dt) for k, (nm, v) in enumerate(
            sorted(outs.items()))}
    return pc, rc, env, keys, g


_REF_VJP: dict = {}


def _ref_vjp(name) -> dict:
    """The reference's VJP at float64 (``jax.vjp`` of its baseline
    evaluator, jitted, as ``tests/test_torch_adjoint.py`` takes it) on
    :func:`_setup`'s inputs, whose values are float32's: once per case,
    for both dtypes."""
    if name not in _REF_VJP:
        _, rc, env, keys, g = _setup(name, np.float64)
        with _x64_ctx(np.float64):
            base = ref_race(rc.program)
            ev = base.baseline_evaluator()
            vjp = jax.jit(lambda p, gg: jax.vjp(lambda q: ref_interior(
                base.plan, ev({**env, **q})), p)[1](gg)[0])
            want = vjp({k: jnp.asarray(env[k]) for k in keys},
                       {k: jnp.asarray(v) for k, v in g.items()})
        _REF_VJP[name] = {k: np.asarray(v) for k, v in want.items()}
    return _REF_VJP[name]


def _per_spec(program, tenv, tg, wrt) -> dict:
    """Each wanted spec run on its own on ``"hopper"``: the path the
    backward takes where there is no group."""
    out = {}
    for spec in adjoint.adjoint_build(program).specs:
        if spec.input in wrt:
            out.update(adjoint._run_unit(spec, tenv, tg, "hopper"))
    return out


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("name", GROUP_CASES)
def test_group_gradients_match_reference_and_per_spec(name, dt, runs):
    """(a) Every float input's gradient from ``backward`` on ``"hopper"``,
    whose scalars run as one group in one summed march, within ``grad``
    (float32) or 1e-10 (float64) of the reference's float64 VJP, and
    within ``plan`` of the per-spec path."""
    pc, rc, env, keys, g = _setup(name, dt)
    tenv, tg = env_to_torch(env, "cpu"), env_to_torch(g, "cpu")
    build = adjoint.adjoint_build(pc.program)
    scalars = [s.input for s in build.specs if s.scalar and s.input in keys]
    assert len(scalars) >= 2
    got = adjoint.backward(pc.program, tenv, tg, backend="hopper", wrt=keys)
    assert runs["apply_sum"] == [sorted(adjoint.ADJOINT_PREFIX + k
                                        for k in scalars)]
    want = _ref_vjp(name)
    tol = default_tolerances(dt)["grad"] if dt == np.float32 else 1e-10
    assert rel_err({k: got[k] for k in keys}, want) <= tol
    per = _per_spec(pc.program, tenv, tg, keys)
    assert rel_err({k: got[k] for k in keys}, per) <= (
        default_tolerances(dt)["plan"])
    for k in scalars:
        assert got[k].shape == () and got[k].dtype == tenv[k].dtype


@pytest.mark.parametrize("name", GROUP_CASES)
def test_backward_runs_the_group_once(name, runs):
    """(b) A backward runs one summed march for its scalars and one run
    per array spec; where ``wrt`` names one scalar there is no group (its
    spec's own summed run), and where it names none, no summed run."""
    pc, _, env, keys, g = _setup(name, np.float32)
    tenv, tg = env_to_torch(env, "cpu"), env_to_torch(g, "cpu")
    build = adjoint.adjoint_build(pc.program)
    arrays = [s.input for s in build.specs if not s.scalar and s.input in keys]
    scalars = [s.input for s in build.specs if s.scalar and s.input in keys]
    for wrt, n_sum in ((keys, 1), (arrays + scalars[:1], 1), (arrays, 0)):
        for v in runs.values():
            v.clear()
        got = adjoint.backward(pc.program, tenv, tg, backend="hopper",
                               wrt=wrt)
        assert len(runs["apply_sum"]) == n_sum, wrt
        assert len(runs["apply"]) == len(arrays), wrt
        assert sorted(k for k, v in got.items() if v is not None) == sorted(
            wrt)
        units = adjoint.adjoint_runs(build, tenv, tg, wrt, "hopper")
        group = build.scalar_group(wrt)
        assert (group is not None) == (wrt is keys)
        assert [type(u).__name__ for u in units] == (
            ["InputSpec"] * (len(wrt) - len(scalars)) + ["ScalarGroup"]
            if group else ["InputSpec"] * len(wrt))


def test_torch_backend_runs_each_spec():
    """On ``"torch"`` the group gains nothing: each spec runs alone."""
    pc, _, env, keys, g = _setup("j3d27pt", np.float32)
    tenv, tg = env_to_torch(env, "cpu"), env_to_torch(g, "cpu")
    build = adjoint.adjoint_build(pc.program)
    units = adjoint.adjoint_runs(build, tenv, tg, keys, "torch")
    assert units == [s for s in build.specs if s.input in keys]
    assert any(isinstance(u, adjoint.ScalarGroup) for u in
               adjoint.adjoint_runs(build, tenv, tg, keys, "hopper"))


def test_wrt_subsets_make_their_own_groups(runs):
    """(c) A subset of the scalars is a group of its own, memoized per
    subset, and gives the per-spec path's gradients."""
    pc, _, env, keys, g = _setup("j3d27pt", np.float64)
    tenv, tg = env_to_torch(env, "cpu"), env_to_torch(g, "cpu")
    build = adjoint.adjoint_build(pc.program)
    for wrt in (["jc1", "jnorm"], ["jc0", "jc2", "jc3", "u"]):
        group = build.scalar_group(wrt)
        assert [s.input for s in group.members] == [k for k in wrt
                                                    if k != "u"]
        assert build.scalar_group(list(reversed(wrt))) is group
        assert len(group.program.body) == len(group.members)
        runs["apply_sum"].clear()
        got = adjoint.backward(pc.program, tenv, tg, backend="hopper",
                               wrt=wrt)
        assert len(runs["apply_sum"]) == 1
        assert rel_err({k: got[k] for k in wrt},
                       _per_spec(pc.program, tenv, tg, wrt)) <= 1e-12


def test_batched_backward_gives_per_example_gradients(runs):
    """(c) ``run_batch``'s backward runs the group once for the batch, and
    each scalar's ``(B,)`` gradient is the per-example backward's."""
    pc, _, env, keys, g = _setup("poisson", np.float64)
    res = repro_torch.race(pc.program, reassociate=pc.reassociate)
    envs = [env_to_torch(env, "cpu"), env_to_torch(
        {k: (v * 0.5 if k == "u" else v) for k, v in env.items()}, "cpu")]
    p = {k: torch.stack([e[k] for e in envs]).requires_grad_() for k in keys}
    out = res.run_batch({**{k: torch.stack([e[k] for e in envs])
                            for k in envs[0]}, **p}, "hopper", device="cpu")
    gb = {k: torch.stack([torch.as_tensor(g[k])] * 2) for k in out}
    runs["apply_sum"].clear()
    hb = dict(zip(keys, torch.autograd.grad(
        [out[k] for k in gb], [p[k] for k in keys], [gb[k] for k in gb])))
    assert len(runs["apply_sum"]) == 1
    for k in keys:
        if np.ndim(env[k]) == 0:
            assert hb[k].shape == (2,)
    for b, e in enumerate(envs):
        q = {k: e[k].clone().requires_grad_() for k in keys}
        o = res.run({**e, **q}, "hopper", device="cpu")
        gs = torch.autograd.grad([o[k] for k in g], [q[k] for k in keys],
                                 [torch.as_tensor(g[k]) for k in g])
        for k, h in zip(keys, gs):
            assert rel_err({k: hb[k][b]}, {k: h}) <= 1e-12, (k, b)


def test_second_order_backward_runs_each_spec(monkeypatch):
    """(c) Under ``create_graph`` the first backward runs every spec on
    its own (``run_sum`` then takes the full products); the product is
    the reference's within ``grad``, as ``tests/test_torch_hvp.py`` holds
    it."""
    pc = get_case("gaussian", 8)
    rc = ref_case("gaussian", 8)
    env = build_env(pc, np.float64)
    read = {r.name for st in pc.program.body for r in expr_refs(st.rhs)}
    env = {k: v for k, v in env.items() if k in read}
    keys = sorted(env)
    rng = np.random.default_rng(7)
    v = {k: rng.standard_normal(np.shape(env[k])) for k in keys}
    seen = []
    run_unit = adjoint._run_unit
    monkeypatch.setattr(adjoint, "_run_unit", lambda u, *a: seen.append(
        (torch.is_grad_enabled(), type(u).__name__)) or run_unit(u, *a))
    res = repro_torch.race(pc.program, reassociate=pc.reassociate)
    got = _port_hvp(res, env, keys, v, "hopper", np.float64)
    first = [t for grad_on, t in seen if grad_on]
    assert first == ["InputSpec"] * len(keys)
    want = _ref_hvp_uncached(rc, env, keys, v, np.float64)
    assert rel_err(got, want) <= default_tolerances(np.float64)["grad"]


def test_race_smooth_taps_run_as_one_group(runs):
    """(d) The mixer's backward: one summed run for its three taps (which,
    together, share the box sum RACE finds) and one run for the stream;
    gradients within ``grad`` of the reference's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    taps = rng.standard_normal(3).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(taps).requires_grad_()
    y = ssm.race_smooth(tx, tt, radius=2, backend="hopper")
    gx, gt = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [tx, tt])
    assert len(runs["apply_sum"]) == 1 and len(runs["apply"]) == 2
    assert runs["apply_sum"][0] == ["_adj_sw0", "_adj_sw1", "_adj_sw2"]
    want = jax.grad(lambda a, b: jnp.sum(ref_ssm.race_smooth(
        a, b, radius=2, backend="xla") * w), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(taps))
    tol = default_tolerances(np.float32)["grad"]
    assert rel_err({"x": gx, "taps": gt},
                   {"x": np.asarray(want[0]),
                    "taps": np.asarray(want[1])}) <= tol
    program = ssm._smooth_result(12, 16, 2).program
    group = adjoint.adjoint_build(program).scalar_group(["sw0", "sw1", "sw2"])
    # alone no tap's adjoint has an aux; together they share the box sum
    assert group.result().n_aux_materialized() >= 1


_REF_GROUPS = """
import json, sys
from repro.apps.paper_kernels import get_case
from repro.core import adjoint, ir
from repro.core.executor import plan_hash, program_hash
from repro.core.race import race
from repro_torch.core.adjoint import group_program

out = {}
for name, n in json.load(sys.stdin):
    case = get_case(name, n)
    specs = [s for s in adjoint.adjoint_build(case.program).specs
             if len(s.sum_axes) == len(s.program.loops)]
    prog, feeds = group_program(case.program, specs, ir=ir)
    res = race(prog, reassociate=3)
    out[name] = dict(program=program_hash(prog), plan=plan_hash(res.plan),
                     reduced_ops=res.reduced_ops(), feeds=repr(feeds))
json.dump(out, sys.stdout)
"""


def test_group_program_and_plan_match_reference_race():
    """(e) The group built in both packages' IR from each package's own
    adjoint programs (whose members are the reference's, as
    ``tests/test_torch_adjoint.py`` holds): equal program hashes and
    feeds, and under each package's ``race`` equal plan hashes and
    ``reduced_ops``.  The reference's side runs in one process under
    ``PYTHONHASHSEED=0``, whose plan the port derives under every seed."""
    sizes = [(name, SWEEP_SIZES[name]) for name in GROUP_CASES]
    proc = subprocess.run([sys.executable, "-c", _REF_GROUPS], env=_env("0"),
                          input=json.dumps(sizes), capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout)
    for name, n in sizes:
        rcase, pcase = ref_case(name, n), get_case(name, n)
        rspecs = [s for s in ref_adjoint.adjoint_build(rcase.program).specs
                  if len(s.sum_axes) == len(s.program.loops)]
        rprog, rfeeds = adjoint.group_program(rcase.program, rspecs,
                                              ir=ref_ir)
        build = adjoint.adjoint_build(pcase.program)
        group = build.scalar_group([s.input for s in build.specs])
        assert ref_program_hash(rprog) == want[name]["program"]
        assert repro_torch.program_hash(group.program) == want[name][
            "program"], name
        assert rfeeds == group.feeds and repr(group.feeds) == want[name][
            "feeds"]
        res = group.result(3)
        assert repro_torch.plan_hash(res.plan) == want[name]["plan"], name
        assert res.reduced_ops() == want[name]["reduced_ops"], name
