"""The port's adjoint construction against the reference's
(``repro/core/adjoint.py``): adjoint programs, plans, probe codes and
refusals equal on the whole registry, the adjoint env assembled entry for
entry as the reference assembles it, and the VJP at float64 on every case
against the reference's.  Where a spec's reference plan follows
PYTHONHASHSEED (ROADMAP F7), the port is held to the reference's plan under
seed 0, taken in a subprocess."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core import adjoint as ref_adjoint
from repro.core.executor import plan_hash as ref_plan_hash
from repro.core.executor import program_hash as ref_program_hash
from repro.core.race import race as ref_race
from repro.kernels.ref import interior as ref_interior
from repro.lowering import analyze_plan as ref_analyze_plan
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import adjoint
from repro_torch.core.codegen import build_baseline_evaluator, interior
from repro_torch.lowering.geometry import analyze_plan
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)
from test_torch_seed import SEED_DEPENDENT_SPECS, reference_under_seed0

pytestmark = pytest.mark.port


def _float_keys(env):
    return sorted(k for k, v in env.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating))


def _weights(n):
    return np.cos(np.arange(n))


# ---------------------------------------------------------------------------
# adjoint structure on the whole registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seed0():
    """The reference's spec records, under PYTHONHASHSEED=0, of the cases
    with a spec whose reference plan follows the seed (F7; the port's does
    not)."""
    return reference_under_seed0(sorted({
        ("specs", name, SWEEP_SIZES[name])
        for name, _ in SEED_DEPENDENT_SPECS}))


@pytest.mark.parametrize("name", list(CASES))
def test_adjoint_structure_matches_reference(name, seed0):
    n = SWEEP_SIZES[name]
    rb = ref_adjoint.adjoint_build(ref_case(name, n).program)
    pb = adjoint.adjoint_build(get_case(name, n).program)
    assert pb.ok == rb.ok and pb.reason == rb.reason
    assert [s.input for s in pb.specs] == [s.input for s in rb.specs]
    for i, (rs, ps) in enumerate(zip(rb.specs, pb.specs)):
        assert (ps.gu, ps.embed, ps.sum_axes, ps.feeds) == (
            rs.gu, rs.embed, rs.sum_axes, rs.feeds)
        assert repro_torch.program_hash(ps.program) == ref_program_hash(
            rs.program)
        pr = ps.result()
        if (name, i) in SEED_DEPENDENT_SPECS:
            want = seed0[("specs", name, n)][i]
            ref_hash, rcodes = want["plan_hash"], want["codes"]
        else:
            rr = rs.result()
            ref_hash = ref_plan_hash(rr.plan)
            rcodes = [r.code for r in ref_analyze_plan(rr.plan).reasons]
        assert repro_torch.plan_hash(pr.plan) == ref_hash
        assert [r.code for r in analyze_plan(pr.plan).reasons] == rcodes
        # the Hopper kernel holds rank-0 aux in registers: its probe drops
        # only the reference's scalar-aux code
        pcap = repro_torch.probe_hopper(pr.plan, ["float32"])
        assert [r.code for r in pcap.reasons] == [
            c for c in rcodes if c != "scalar-aux"]


@pytest.mark.parametrize("name,code", [("rprj3", adjoint.STRIDED_READ),
                                       ("diag2d", adjoint.REPEATED_LEVEL)])
def test_refusal_codes_are_the_reference_codes(name, code):
    assert code == getattr(ref_adjoint, code)
    build = adjoint.adjoint_build(get_case(name, SWEEP_SIZES[name]).program)
    assert not build.ok and build.reason.startswith(code) and not build.specs


def test_nine_refusal_codes():
    names = ["STRIDED_READ", "REPEATED_LEVEL", "CONST_DIM", "MIXED_LAYOUT",
             "READ_AFTER_WRITE", "NONDIFF_OP", "NON_INTEGRAL", "LHS_FORM",
             "NEGATIVE_INDEX"]
    assert [getattr(adjoint, n) for n in names] == [
        getattr(ref_adjoint, n) for n in names]


@pytest.mark.parametrize("name", list(CASES))
def test_vjp_matches_reference_float64(name):
    """At float64 on every case, against the reference's VJP of the
    baseline program (``jax.vjp``, jitted): ``backward`` itself (adjoint
    plans on the default backend: the emulated kernel where the probe
    admits them) within ``grad``, and autograd through the port's baseline
    evaluator, the fallback's path, within 1e-12.  The latter runs through
    its slice reads, advanced-index reads (mirrored axes, repeated levels)
    and in-place slice writes into a zeros buffer or a clone."""
    n = SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    env = build_env(pc, np.float64, seed=2)
    keys = _float_keys(env)
    res = repro_torch.race(pc.program)
    tenv = env_to_torch(env, "cpu")
    run = build_baseline_evaluator(pc.program)
    p = {k: tenv[k].clone().requires_grad_() for k in keys}
    outs = interior(res.plan, run({**tenv, **p}))
    g = {k: torch.as_tensor(_weights(v.numel()).reshape(tuple(v.shape)))
         for k, v in outs.items()}
    with _x64_ctx(np.float64):
        base = ref_race(rc.program)
        ev = base.baseline_evaluator()
        vjp = jax.jit(lambda q: jax.vjp(
            lambda e: ref_interior(base.plan, ev({**env, **e})), q)[1](
                {k: jnp.asarray(v.numpy()) for k, v in g.items()})[0])
        want = {k: np.asarray(v) for k, v in vjp(
            {k: jnp.asarray(env[k]) for k in keys}).items()}

    got = adjoint.backward(pc.program, tenv, g)
    assert set(got) == set(env)
    got = {k: torch.zeros_like(tenv[k]) if got[k] is None else got[k]
           for k in keys}
    assert rel_err(got, want) <= default_tolerances(np.float64)["grad"]

    gs = torch.autograd.grad([outs[k] for k in g], [p[k] for k in keys],
                             [g[k] for k in g], allow_unused=True)
    auto = {k: torch.zeros_like(p[k]) if v is None else v
            for k, v in zip(keys, gs)}
    assert rel_err(auto, want) <= 1e-12


@pytest.mark.parametrize("name", ["j3d27pt", "gaussian", "mirror_deriv"])
def test_scalar_aux_adjoint_on_hopper_matches_reference(name):
    """The ``u`` adjoints whose plans hold rank-0 aux (the reference's
    ``scalar-aux``) run on ``"hopper"`` (its tile emulator here: the rank-0
    aux in registers) and match the reference's VJP at float64."""
    n = SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    spec = next(s for s in adjoint.adjoint_build(pc.program).specs
                if s.input == "u")
    plan = spec.result().plan
    assert {r.code for r in analyze_plan(plan).reasons} == {"scalar-aux"}
    assert repro_torch.probe_hopper(plan, ["float64"]).eligible
    env = build_env(pc, np.float64, seed=4)
    tenv = env_to_torch(env, "cpu")
    res = repro_torch.race(pc.program)
    outs = interior(res.plan, res.baseline_evaluator()(tenv))
    g = {k: torch.as_tensor(_weights(v.numel()).reshape(tuple(v.shape)))
         for k, v in outs.items()}
    with _x64_ctx(np.float64):
        base = ref_race(rc.program)
        ev = base.baseline_evaluator()
        _, vjp = jax.vjp(lambda u: ref_interior(
            base.plan, ev({**env, "u": u})), jnp.asarray(env["u"]))
        (want,) = vjp({k: jnp.asarray(v.numpy()) for k, v in g.items()})
    got = adjoint.backward(pc.program, tenv, g, backend="hopper",
                           wrt=["u"])["u"]
    assert rel_err({"u": got}, {"u": np.asarray(want)}) <= (
        default_tolerances(np.float64)["grad"])


@pytest.mark.parametrize("name", ["gaussian", "derivative", "mirror_deriv",
                                  "calc_tpoints"])
def test_assemble_adjoint_env_matches_reference(name):
    """Zero-padded cotangent canvases, ones-padded coefficient arrays and
    passed-through scalars, entry for entry."""
    n = SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    env = build_env(pc, seed=5)
    rb = ref_adjoint.adjoint_build(rc.program)
    pb = adjoint.adjoint_build(pc.program)
    rng = np.random.default_rng(6)
    res = repro_torch.race(pc.program)
    outs = interior(res.plan, res.baseline_evaluator()(
        env_to_torch(env, "cpu")))
    g = {k: rng.uniform(-1, 1, tuple(v.shape)).astype(np.float32)
         for k, v in outs.items()}
    for rs, ps in zip(rb.specs, pb.specs):
        want = ref_adjoint.assemble_adjoint_env(rs, env, g)
        got = adjoint.assemble_adjoint_env(ps, env_to_torch(env, "cpu"),
                                           env_to_torch(g, "cpu"))
        assert sorted(got) == sorted(want)
        shapes = adjoint.adjoint_env_shapes(
            ps, pc.program, {k: np.shape(v) for k, v in env.items()})
        assert shapes == {k: tuple(v.shape) for k, v in got.items()}
        for k in want:
            assert got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# scalar adjoints summed in the kernel
# ---------------------------------------------------------------------------

#: the registry's cases with a scalar-coefficient adjoint spec
SCALAR_CASES = ["calc_tpoints", "ocn_export", "rhs_ph1", "rhs_ph2",
                "diffusion1", "diffusion2", "diffusion3", "psinv", "resid",
                "gaussian", "j3d27pt", "poisson", "derivative", "smooth1d",
                "blocked4d", "mirror_deriv"]


def _scalar_program(name):
    """The program and its float64 env: the mixer's at S = 40 over 96
    channels, or a registry case's at its sweep size."""
    if name == "mixer":
        from repro_torch.models import ssm

        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((2, 40, 48)))
        taps = torch.from_numpy(rng.standard_normal(3))
        env = {k: v.double() for k, v in ssm.smooth_env(x, taps, 2).items()}
        return ssm._smooth_result(40, 96, 2).program, env
    case = get_case(name, SWEEP_SIZES[name])
    return case.program, env_to_torch(build_env(case, np.float64, seed=7),
                                      "cpu")


@pytest.mark.parametrize("name", ["mixer"] + SCALAR_CASES)
def test_scalar_spec_partials_sum_to_the_products(name):
    """Every scalar spec the probe admits, on ``"hopper"`` (the emulator's
    summed march): ``run_sum`` gives one partial per block of the grid,
    ``(n_tiles,)`` and batched ``(B, n_tiles)``, in float64, whose sum is
    the sum of the full products ``g b`` that ``run`` writes within
    ``grad`` at float32 and 1e-10 at float64, both relative to ``sum
    |g b|``; ``finalize_adjoint`` takes either."""
    program, env64 = _scalar_program(name)
    build = adjoint.adjoint_build(program)
    specs = [s for s in build.specs if s.scalar]
    assert specs
    res = repro_torch.race(program)
    outs = interior(res.plan, res.baseline_evaluator()(env64))
    rng = np.random.default_rng(3)
    g64 = {k: torch.from_numpy(rng.uniform(-1, 1, tuple(v.shape)))
           for k, v in outs.items()}
    ran = 0
    for dt, tol in ((torch.float32, default_tolerances("float32")["grad"]),
                    (torch.float64, 1e-10)):
        env = {k: v.to(dt) if v.is_floating_point() else v
               for k, v in env64.items()}
        g = {k: v.to(dt) for k, v in g64.items()}
        for spec in specs:
            plan = spec.result().plan
            if not repro_torch.probe_hopper(plan, [str(dt)[6:]]).eligible:
                continue
            a = adjoint.assemble_adjoint_env(spec, env, g)
            ex = repro_torch.compile_plan(plan, a, "hopper")
            n_tiles = ex.spec.tp.geometry.n_tiles
            full = ex(a)[spec.gu].double()
            parts = ex.run_sum(a)[spec.gu]
            assert parts.shape == (n_tiles,) and parts.dtype == torch.float64
            scale = float(full.abs().sum())
            assert abs(float(parts.double().sum() - full.sum())) <= (
                tol * scale)
            assert torch.equal(adjoint.finalize_adjoint(spec, env, parts),
                               parts.sum().to(dt))
            # a batch of two: the example, then its cotangents doubled
            # (a scalar's adjoint is linear in them)
            stacked = {k: torch.stack([v, 2 * v if k.startswith(
                adjoint.COTANGENT_PREFIX) else v]) for k, v in a.items()}
            batch = ex.run_sum(stacked, batched=True)[spec.gu]
            assert batch.shape == (2, ex.spec.program(2).geometry.n_tiles)
            assert batch.dtype == torch.float64
            sums = batch.double().sum(1)
            assert abs(float(sums[0] - full.sum())) <= tol * scale
            assert abs(float(sums[1] - 2 * full.sum())) <= 2 * tol * scale
            ran += 1
    assert ran
