"""The Hopper stencil kernel's tile program: its CPU emulator against the
reference's ``"xla"`` plan output (and once against the reference Pallas
kernel in interpret mode), its CUDA rendering, its tile chooser and its
refusals."""
import numpy as np
import pytest

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import ir
from repro_torch.core.backend import BackendUnavailable
from repro_torch.core.codegen import required_shapes
from repro_torch.lowering import (R_HOPPER_DTYPE, R_HOPPER_SMEM,
                                  LoweringError, analyze_plan)
from repro_torch.lowering.blocks import (LINE_BYTES, MAX_PLANE_POINTS,
                                         SMEM_BUDGET, SMEM_LIMIT,
                                         build_geometry, schedule)
from repro_torch.lowering.emit import (emulate, render_cuda,
                                       specialize_stencil, tile_program)
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)

pytestmark = pytest.mark.port


def _ref_plan_output(rc, lvl, dt, env, backend="xla"):
    with _x64_ctx(dt):
        res = ref_race(rc.program, reassociate=lvl, rewrite_div=rc.rewrite_div)
        return {k: np.asarray(v) for k, v in res.run(env, backend).items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulator_matches_reference_xla(name, which, dtype):
    """The ``"hopper"`` backend on the CPU runs the tile emulator; it is held
    against the reference XLA plan output at the chooser's tiles and at small
    forced plane tiles and segments (many blocks, overhang on every level,
    rings that wrap and segments that end inside the extent)."""
    dt = np.dtype(dtype).type
    rc, pc = ref_case(name, SWEEP_SIZES[name]), get_case(name, SWEEP_SIZES[name])
    lvl = 0 if which == "r0" else rc.reassociate
    env = build_env(pc, dt)
    want = _ref_plan_output(rc, lvl, dt, env)
    res = repro_torch.race(pc.program, reassociate=lvl,
                           rewrite_div=pc.rewrite_div)
    tol = default_tolerances(dt)["plan"]
    got = res.run(env, "hopper", device="cpu")
    assert rel_err(got, want) <= tol
    small = res.run(env, "hopper", device="cpu", block_rows=4, block_cols=2,
                    block_inner=3)
    assert rel_err(small, want) <= tol
    shapes = required_shapes(pc.program)
    g = tile_program(res.plan, shapes, {k: dtype for k in shapes}, 4, 2,
                     3).geometry
    if g.s_level:  # segments end inside the extent; aux rings wrap
        assert g.nb[g.s_level - 1] > 1
        assert all(g.seg - g.k0 > r.depth for r in g.rings
                   if r.streamed and not r.operand)


@pytest.mark.pallas
def test_emulator_matches_reference_pallas_kernel():
    """One float32 case against the reference Pallas kernel run in interpret
    mode, as the reference's own tests run it: the two kernels agree."""
    rc, pc = ref_case("j3d27pt", 10), get_case("j3d27pt", 10)
    env = build_env(pc, np.float32)
    want = _ref_plan_output(rc, rc.reassociate, np.float32, env, "pallas")
    res = repro_torch.race(pc.program, reassociate=pc.reassociate)
    got = res.run(env, "hopper", device="cpu")
    assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]


def _specs(name, which, n=None):
    case = get_case(name, n or SWEEP_SIZES[name])
    lvl = 0 if which == "r0" else case.reassociate
    res = repro_torch.race(case.program, reassociate=lvl,
                           rewrite_div=case.rewrite_div)
    shapes = required_shapes(case.program)
    return res, shapes


@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_render_cuda_one_global_per_plan(name, which):
    res, shapes = _specs(name, which)
    for dtype in ("float32", "float64"):
        src = specialize_stencil(res.plan, shapes,
                                 {k: dtype for k in shapes}).source
        assert src.count("__global__") == 1
        assert src.count('extern "C" int race_stencil_launch(') == 1
        assert "launch<float>" in src and "launch<double>" in src
        assert "float32" not in src  # constants are never rounded to f32


def test_render_cuda_keeps_constants_at_double_precision():
    loops, (i,) = ir.loopnest(("i", 1, 30))
    u, o = ir.arr("u"), ir.arr("o")
    prog = ir.program(loops, [(o[i], 0.1 * (u[i - 1] + u[i + 1])
                               + 0.1 * (u[i] + u[i + 2]))])
    res = repro_torch.race(prog, reassociate=3)
    shapes = required_shapes(prog)
    src = render_cuda(tile_program(res.plan, shapes,
                                   {k: "float64" for k in shapes}))
    assert "scalar_t(0.1)" in src
    env = {k: np.random.default_rng(0).uniform(-1, 1, s)
           for k, s in shapes.items()}
    got = res.run(env, "hopper", device="cpu")["o"].numpy()
    u = env["u"]
    want = (0.1 * (u[0:30] + u[2:32]) + 0.1 * (u[1:31] + u[3:33]))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_tile_chooser_respects_smem_budget(name):
    """At the test sizes and at 512 points a side, for both dtypes: the
    rings (aux and staged operands) fit the budget, the x-level's tile
    spans a 128-byte line where the extent allows, the plane tile stays
    within MAX_PLANE_POINTS, and the segments cover the stream level."""
    for n in (SWEEP_SIZES[name], 512 if name != "blocked4d" else 64):
        for which in ("r0", "default"):
            res, _ = _specs(name, which, n)
            for itemsize in (4, 8):
                g = build_geometry(res.plan, itemsize)
                smem = g.smem_elems * itemsize
                assert smem <= SMEM_BUDGET
                assert g.plane_points <= MAX_PLANE_POINTS
                ext_x = g.extents[g.x_level - 1]
                assert g.tile[g.x_level - 1] >= min(LINE_BYTES // itemsize,
                                                    ext_x)
                assert g.order[0] == g.x_level
                assert g.n_tiles == np.prod(
                    [-(-e // t) for e, t in zip(g.extents, g.tile)])
                if g.s_level:
                    assert g.seg <= g.extents[g.s_level - 1]


def test_x_level_is_the_contiguous_dimension():
    """Fortran-ordered 3-D cases (``u[i,k,j]`` under loops ``(j,k,i)``) put
    the x-level at loop level 1."""
    res, _ = _specs("j3d27pt", "default", 64)
    g = build_geometry(res.plan, 4)
    assert g.x_level == 1 and g.tile[0] == LINE_BYTES // 4


def _wide_reuse_program():
    """u*v reused at shifts 0 and 120 on all three levels: its aux ring
    spans 121 points a side even at a one-point plane tile."""
    loops, (i, j, k) = ir.loopnest(("i", 1, 8), ("j", 1, 8), ("k", 1, 8))
    u, v, o = ir.arr("u"), ir.arr("v"), ir.arr("o")
    far = (i + 120, j + 120, k + 120)
    return ir.program(loops, [(o[i, j, k], u[i, j, k] * v[i, j, k]
                               + u[far] * v[far])])


def test_smem_refusal_code():
    prog = _wide_reuse_program()
    res = repro_torch.race(prog)
    a = analyze_plan(res.plan)
    assert a.eligible and len(res.plan.aux_order) == 1
    # the aux ring alone (no operand staged) at a one-point plane tile
    assert schedule(res.plan, stage=False).footprint(
        {1: 1, 2: 1, 3: 1}) * 4 > SMEM_LIMIT
    cap = res.capability()
    assert not cap.eligible
    assert [r.code for r in cap.reasons] == [R_HOPPER_SMEM]
    sel = res.select_backend("auto")
    assert sel.backend == "torch" and sel.fell_back
    with pytest.raises(BackendUnavailable):
        res.select_backend("hopper")
    shapes = required_shapes(prog)
    with pytest.raises(LoweringError) as err:
        tile_program(res.plan, shapes, {k: "float32" for k in shapes})
    assert err.value.codes == (R_HOPPER_SMEM,)
    env = {k: np.ones(s, np.float32) for k, s in shapes.items()}
    out = res.run(env, device="cpu")["o"]  # auto: the torch evaluator
    assert float(out.min()) == float(out.max()) == 2.0


def test_dtype_refusal_code():
    case = get_case("hdifft_gm", 14)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case, np.float16), "cpu")
    ex = repro_torch.compile_plan(res.plan, env, "auto")
    assert ex.backend == "torch"
    assert [r.code for r in ex.selection.capability.reasons] == [
        R_HOPPER_DTYPE]
    with pytest.raises(BackendUnavailable):
        repro_torch.compile_plan(res.plan, env, "hopper")
    shapes = required_shapes(case.program)
    with pytest.raises(LoweringError) as err:
        tile_program(res.plan, shapes, {k: "float16" for k in shapes})
    assert err.value.codes == (R_HOPPER_DTYPE,)


def test_emulator_reads_outside_the_array_as_zero():
    """Guarded loads: a mirrored (negative-coefficient) read at the far edge
    and tile overhang both stay inside the arrays the emulator touches."""
    res, shapes = _specs("mirror_deriv", "default")
    tp = tile_program(res.plan, shapes, {k: "float64" for k in shapes},
                      block_rows=8, block_cols=8)
    assert any(e % t for e, t in zip(tp.geometry.extents, tp.geometry.tile))
    env = env_to_torch(build_env(get_case("mirror_deriv", 14), np.float64),
                       "cpu")
    out = emulate(tp, env)
    want = res.run(env, "torch", device="cpu")
    assert rel_err(out, want) <= 1e-12
