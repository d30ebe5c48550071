"""The port's small entry points and oracles against the reference's:
``kernels/ref.py`` (``reference``, ``reference_plan``, ``interior``),
``codegen.build_evaluator``, ``kernels/ops.py`` (``race_stencil`` on the
kernel, which never falls back, and ``optimize_and_run``), the deprecated
``kernels/race_stencil.py`` shim, and ``core/integration.py``'s RoPE
hoisting analysis (``tests/test_system.py::test_rope_hoisting_via_race``)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_case
from repro.core.codegen import build_evaluator as ref_build_evaluator
from repro.core.executor import plan_hash as ref_plan_hash
from repro.core.executor import program_hash as ref_program_hash
from repro.core.integration import rope_hoisting_plan as ref_rope
from repro.core.race import race as ref_race
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref

import repro_torch
from repro_torch.apps import CASES, get_case
from repro_torch.core import executor
from repro_torch.core.backend import BackendUnavailable
from repro_torch.core.codegen import build_evaluator
from repro_torch.core.integration import rope_hoisting_plan, rope_nest
from repro_torch.kernels import ops, ref
from repro_torch.kernels import race_stencil as shim
from test_torch_seed import SEED_DEPENDENT_PLANS, reference_under_seed0
from repro_torch.lowering.emit import LoweredStencil, specialize_stencil
from repro_torch.lowering.facts import LoweringError
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 rel_err)

pytestmark = pytest.mark.port

PLAN = default_tolerances(np.float32)["plan"]


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _pair(name, n=None):
    n = n or SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    kw = dict(reassociate=pc.reassociate, rewrite_div=pc.rewrite_div)
    return rc, pc, ref_race(rc.program, **kw), repro_torch.race(pc.program,
                                                                **kw)


@pytest.mark.parametrize("name", CASES)
def test_reference_oracles_match_the_reference(name):
    """``reference`` (the baseline program) and ``reference_plan`` (the
    plan's evaluator), interior-sliced, equal the reference's oracles on the
    same numpy env within ``plan``."""
    rc, pc, rres, res = _pair(name)
    env = build_env(pc)
    for port_fn, ref_fn in ((ref.reference, ref_ref.reference),
                            (ref.reference_plan, ref_ref.reference_plan)):
        got = port_fn(res.plan, env, device="cpu")
        want = {k: np.asarray(v) for k, v in ref_fn(rres.plan, env).items()}
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert {v.device.type for v in got.values()} == {"cpu"}
        assert rel_err(got, want) <= PLAN, port_fn.__name__
    assert ref.interior is repro_torch.core.codegen.interior


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
@pytest.mark.parametrize("name", ["hdifft_gm", "j3d27pt", "diag2d"])
def test_build_evaluator_matches_the_reference(name, backend):
    rc, pc, rres, res = _pair(name)
    env = build_env(pc)
    run, sel = build_evaluator(res.plan, backend, device="cpu")
    want_run, _ = ref_build_evaluator(rres.plan, "xla")
    assert sel.requested == backend
    assert sel.backend == ("torch" if backend == "torch" else "hopper")
    assert sel.capability.eligible
    got = run(env)
    assert {v.device.type for v in got.values()} == {"cpu"}
    assert rel_err(got, want_run(env)) <= PLAN


def test_build_evaluator_hopper_raises_on_what_the_kernel_refuses():
    _, pc, _, res = _pair("hdifft_gm")
    env16 = build_env(pc, np.float16)
    run, sel = build_evaluator(res.plan, "hopper", device="cpu")
    assert {v.dtype for v in run(env16).values()} == {torch.float16}
    # operands that mix dtypes stay refused
    first = sorted(k for k, v in env16.items() if np.ndim(v))[0]
    mixed = {**env16, first: env16[first].astype(np.float32)}
    with pytest.raises(BackendUnavailable, match="hopper-dtype"):
        run(mixed)
    run_auto, _ = build_evaluator(res.plan, "auto", device="cpu")
    assert {v.dtype for v in run_auto(env16).values()} == {torch.float16}
    assert all(torch.isfinite(v).all() for v in run_auto(mixed).values())


@pytest.mark.parametrize("name,n", [("hdifft_gm", 14), ("smooth1d", 24)])
def test_race_stencil_matches_the_reference_kernel(name, n):
    """The port's ``race_stencil`` (the kernel's tile emulator on the CPU)
    against the reference's Pallas ``race_stencil`` in interpret mode, as
    the reference's own tests run it, within ``plan``; it launches through
    the executor's ``"hopper"`` wrapper."""
    rc, pc, rres, res = _pair(name, n)
    env = build_env(pc)
    got = ops.race_stencil(res, env, device="cpu")
    want = ref_ops.race_stencil(rres, env)
    assert rel_err(got, {k: np.asarray(v) for k, v in want.items()}) <= PLAN
    (key,) = executor.executor_cache().keys()
    assert key.backend == "hopper"


def test_race_stencil_never_falls_back():
    _, pc, _, res = _pair("hdifft_gm")
    with pytest.raises(BackendUnavailable, match="hopper-dtype"):
        ops.race_stencil(res, build_env(pc, np.int32), device="cpu")
    assert len(executor.executor_cache()) == 0
    got = ops.race_stencil(res, build_env(pc, np.float16), device="cpu")
    assert {v.dtype for v in got.values()} == {torch.float16}
    (key,) = executor.executor_cache().keys()
    assert key.backend == "hopper"


def test_optimize_and_run_matches_the_reference():
    rc, pc, _, _ = _pair("j3d27pt", 8)
    env = build_env(pc)
    res, got = ops.optimize_and_run(pc.program, env, device="cpu")
    rres, want = ref_ops.optimize_and_run(rc.program, env)
    assert res.options["reassociate"] == 3
    # j3d27pt's reference plan at reassociate=3 follows PYTHONHASHSEED
    # (ROADMAP F7): the port's is the reference's under seed 0
    assert ("j3d27pt", 3) in SEED_DEPENDENT_PLANS
    (seed0,) = reference_under_seed0([("plan", "j3d27pt", 8, 3)]).values()
    assert repro_torch.plan_hash(res.plan) == seed0["plan_hash"]
    assert rel_err(got, {k: np.asarray(v) for k, v in want.items()}) <= PLAN


def test_race_stencil_shim_names():
    assert shim.StencilSpec is LoweredStencil is shim.LoweredStencil
    assert shim.specialize_stencil is specialize_stencil
    assert shim.LoweringError is LoweringError
    assert set(shim.__all__) == {"LoweredStencil", "LoweringError",
                                 "StencilSpec", "specialize_stencil"}
    for gone in ("plan_geometry", "race_stencil_call"):
        assert not hasattr(shim, gone) and gone in shim.__doc__


@pytest.mark.parametrize("layers,seq,half_dh", [(6, 8, 4), (4, 8, 4),
                                                (3, 5, 3)])
def test_rope_hoisting_matches_the_reference(layers, seq, half_dh):
    """The per-(l, p, d) trig count collapses by exactly 1/L, as in the
    reference, with the hoisted aux off the layer loop and the same plan."""
    rep = rope_hoisting_plan(n_layers=layers, seq=seq, half_dh=half_dh)
    want = ref_rope(n_layers=layers, seq=seq, half_dh=half_dh)
    assert rep.layer_invariant and want.layer_invariant
    assert rep.sincos_per_iter_before == want.sincos_per_iter_before
    assert rep.sincos_per_iter_after == pytest.approx(
        want.sincos_per_iter_after, rel=1e-12)
    assert rep.sincos_per_iter_after == pytest.approx(
        rep.sincos_per_iter_before / layers, rel=1e-6)
    for aux in rep.result.plan.aux_order:
        assert 1 not in aux.levels  # level 1 = the layer loop
    assert repro_torch.plan_hash(rep.result.plan) == ref_plan_hash(
        want.result.plan)
    assert repro_torch.program_hash(rope_nest(layers, seq, half_dh)) == (
        ref_program_hash(want.result.program))
