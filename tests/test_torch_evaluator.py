"""The port's whole-array ``"torch"`` backend on the CPU against the
reference's ``"xla"`` backend: same plans, same numpy inputs, ``plan``
tolerance; and the baseline evaluators against each other."""
import jax
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core.codegen import build_baseline_evaluator as ref_baseline
from repro.core.race import race as ref_race
from repro.kernels.ref import interior as ref_interior
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core.codegen import build_baseline_evaluator, interior
from repro_torch.testing import (SWEEP_SIZES, build_env, coverage_matrix,
                                 default_tolerances, env_to_torch, rel_err,
                                 run_case, sweep_registry)

pytestmark = pytest.mark.port


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_torch_backend_matches_reference_xla(name, which, dtype):
    dt = np.dtype(dtype).type
    rc, pc = ref_case(name, SWEEP_SIZES[name]), get_case(name, SWEEP_SIZES[name])
    lvl = 0 if which == "r0" else rc.reassociate
    env = build_env(pc, dt)
    with _x64_ctx(dt):
        want = {k: np.asarray(v) for k, v in ref_race(
            rc.program, reassociate=lvl, rewrite_div=rc.rewrite_div
        ).run(env, "xla").items()}
    res = repro_torch.race(pc.program, reassociate=lvl,
                           rewrite_div=pc.rewrite_div)
    got = res.run(env, "torch", device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{dtype}"
    assert rel_err(got, want) <= default_tolerances(dt)["plan"]


@pytest.mark.parametrize("name", list(CASES))
def test_baseline_evaluator_matches_reference(name):
    rc, pc = ref_case(name, SWEEP_SIZES[name]), get_case(name, SWEEP_SIZES[name])
    env = build_env(pc, np.float32)
    res = repro_torch.race(pc.program)
    want = jax.jit(lambda e: ref_interior(
        ref_race(rc.program).plan, ref_baseline(rc.program)(e)))(env)
    got = interior(res.plan, build_baseline_evaluator(pc.program)(
        env_to_torch(env, "cpu")))
    assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]


def test_sweep_registry_holds_both_backends_against_the_baseline():
    """``run_case`` over both backends: each against the float64 baseline
    within ``baseline``, the (emulated) kernel against ``"torch"`` on the
    same plan within ``plan``, float16 on the kernel too; a refused dtype
    (int32) is a named fallback."""
    reports = sweep_registry(["hdifft_gm", "rprj3", "blocked4d"],
                             reassociate_levels=(0, 3), device="cpu")
    assert not [f for r in reports for f in r.failures()]
    hopper = [c for r in reports for c in r.combos if c.backend == "hopper"]
    assert len(hopper) == 6 and all(c.ok for c in hopper)
    assert all(c.max_rel_err_plan <= default_tolerances(np.float32)["plan"]
               for c in hopper)
    assert "ok" in coverage_matrix(reports)
    half = run_case(get_case("smooth1d", 24), reassociate_levels=(3,),
                    dtype=np.float16, device="cpu")
    (k1,) = [c for c in half.combos if c.backend == "hopper"]
    assert k1.ok and (k1.max_rel_err_plan
                      <= default_tolerances(np.float16)["plan"])
    ints = run_case(get_case("smooth1d", 24), reassociate_levels=(3,),
                    dtype=np.int32, device="cpu",
                    tolerances=default_tolerances(np.float32))
    (fb,) = [c for c in ints.combos if c.backend == "hopper"]
    assert fb.status == "fallback" and fb.reason.startswith("hopper-dtype")
    assert "torch[hopper-dtype]" in coverage_matrix([ints])
