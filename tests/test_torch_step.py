"""K1's march step (``repro_torch/lowering/blocks.py``: the phases, the
common pitch, the blocks an SM; ``lowering/emit.py``: ``render_cuda``'s
fixed thread maps and ``emulate``): the rendered source's barriers, index
arithmetic and launch bounds at full-size shapes, the slot invariant, lane
use and blocks an SM as the geometry gives them, and the emulator against
the reference's ``"xla"`` at the four dtypes, stored and summed (nvcc is
absent here: the kernel itself runs in ``chip_smoke.py``)."""
import functools
import re

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case

import repro_torch
from repro_torch.apps import get_case
from repro_torch.apps.paper_kernels import pop_hdifft_gm
from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
from repro_torch.core.backend import probe_hopper
from repro_torch.core.codegen import required_shapes
from repro_torch.lowering import blocks
from repro_torch.lowering.emit import (KERNEL_DTYPES, emulate, render_cuda,
                                       step_loops, tile_program)
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)

from test_torch_half import _envs, _ref_xla
from test_torch_stencil import _ref_plan_output
from test_torch_stream import _replay

pytestmark = pytest.mark.port

DTYPES = ("float32", "float64", "float16", "bfloat16")


def _full_n(name: str) -> int:
    return 64 if name == "blocked4d" else 512


@functools.lru_cache(maxsize=None)
def _full_plans(name: str) -> list:
    """``(label, plan, shapes, summed)`` of the case at a full-size shape:
    its level-0 and default-level plans and, where the kernel's probe
    admits it, its scalars' group (a summed launch)."""
    case = get_case(name, _full_n(name))
    shapes = required_shapes(case.program)
    out = [(f"r{lvl}", repro_torch.race(case.program, reassociate=lvl,
                                        rewrite_div=case.rewrite_div).plan,
            shapes, False) for lvl in sorted({0, case.reassociate})]
    build = adjoint_build(case.program)
    group = build.scalar_group([s.input for s in build.specs])
    if group is not None and probe_hopper(group.result().plan,
                                          ["float32"]).eligible:
        out.append(("scalars", group.result().plan,
                    adjoint_env_shapes(group, case.program, shapes), True))
    return out


def _march(src: str, g) -> str:
    """The body of the march loop, comments taken out."""
    march = src.split(f"  for (int k = {g.k0}; k < {g.seg}; ++k) {{\n")[1]
    return re.sub(r"//[^\n]*", "", march.split("\n  }\n")[0])


#: a line of the march that defines an integer (an index, a slot, a flag)
INT_LINE = re.compile(r"^\s*(?:const\s+)?(?:int|bool|long long)\s+\w+\s*=")


@pytest.mark.parametrize("name", list(CASES))
def test_march_has_its_barriers_and_no_index_division(name):
    """(a) At full-size shapes, every default-level and level-0 plan and
    every scalars' group renders a march with the barriers a step its
    geometry states (one before each phase), no index arithmetic by ``%``
    anywhere or by ``/`` in a line that defines an integer (a value may
    divide), and no loop: each box is a fixed count of rounds a thread."""
    for label, plan, shapes, summed in _full_plans(name):
        for dt in ("float32", "float64"):
            tp = tile_program(plan, shapes, {k: dt for k in shapes})
            g = tp.geometry
            code = _march(render_cuda(tp, summed), g)
            assert "%" not in code, label
            assert not [ln for ln in code.splitlines()
                        if INT_LINE.match(ln) and "/" in ln], label
            assert "for (" not in code and "while" not in code, label
            assert code.count("__syncthreads()") == g.barriers == len(
                g.phases), label


@pytest.mark.parametrize("name", list(CASES))
def test_march_keeps_the_slot_invariant(name):
    """(b) The march replayed on plane numbers: no slot is read in the
    phase that writes it or in the step that loads it, and every read
    finds its plane (``test_torch_stream._replay``)."""
    for label, plan, shapes, _ in _full_plans(name):
        for dt in ("float32", "float64"):
            tp = tile_program(plan, shapes, {k: dt for k in shapes})
            _replay(tp)


@pytest.mark.parametrize("name", list(CASES))
def test_phases_follow_the_same_step_reads(name):
    """A step's barriers are its phases: an aux's phase is one more than
    the latest phase of an aux plane it reads at its own step, the body's
    likewise (0 where it reads only older planes, so it shares the head's
    barrier), and there is one barrier before each phase: never more than
    the aux phases and the head, as before the step's redesign."""
    for label, plan, shapes, _ in _full_plans(name):
        tp = tile_program(plan, shapes, {k: "float32" for k in shapes})
        g = tp.geometry
        aux = len(tp.aux_exprs)

        def want(ctx):
            return 1 + max([g.rings[rd.ring].phase
                            for (c, _), rd in g.reads.items()
                            if c == ctx and rd.ring < aux
                            and g.rings[rd.ring].streamed
                            and rd.back == 0], default=-1)

        planes = [k for k in range(aux) if g.rings[k].streamed]
        assert all(g.rings[k].phase == want(k) for k in planes), label
        assert g.body_phase == want(blocks.BODY), label
        aux_phases = {g.rings[k].phase for k in planes}
        assert g.phases == tuple(sorted(aux_phases | {g.body_phase}))
        assert g.barriers == len(g.phases) <= len(aux_phases) + 1, label


def _phase4(name, n, dt):
    case = pop_hdifft_gm(n, n) if name == "hdifft_gm" else get_case(name, n)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    shapes = required_shapes(case.program)
    return tile_program(res.plan, shapes, {k: dt for k in shapes})


@pytest.mark.parametrize("name", list(CASES))
def test_lane_use_and_blocks_follow_the_geometry(name):
    """(c) Lane use is the step's box elements over its rounds' thread
    slots, the rounds at least those elements need; the blocks an SM are
    what the shared memory allows (228 KB an SM, 1 KB reserved a block,
    the static 256 B), and ``__launch_bounds__`` asks for them, held at
    the register floor."""
    for label, plan, shapes, summed in _full_plans(name):
        for dt in ("float32", "float64"):
            tp = tile_program(plan, shapes, {k: dt for k in shapes})
            g = tp.geometry
            loops = step_loops(tp)
            useful = sum(x.useful for x in loops)
            assert sum(x.rounds for x in loops) == tp.rounds_per_step
            assert tp.rounds_per_step >= -(-useful // g.threads)
            assert tp.lane_use == pytest.approx(
                useful / (tp.rounds_per_step * g.threads))
            assert tp.smem_bytes == g.smem_elems * KERNEL_DTYPES[dt].shared
            assert g.smem_elems >= sum(r.size for r in g.rings)
            assert g.smem_blocks == min(
                233472 // (tp.smem_bytes + 256 + 1024), 2048 // g.threads,
                32)
            assert g.blocks == min(g.smem_blocks,
                                   65536 // (g.threads * 64))
            src = render_cuda(tp, summed)
            assert (f"__launch_bounds__({g.threads}, {g.blocks}) "
                    "race_stencil_kernel(") in src
            static = blocks.STATIC_SHARED if summed else 0
            launcher = src[src.index("int launch("):]
            opt_in = launcher.index(
                f"  if (smem + {static} > 48 * 1024) {{\n"
                "    const cudaError_t err = cudaFuncSetAttribute(")
            assert opt_in < launcher.index("<<<"), label


def test_launcher_opts_in_where_static_bytes_tip_it_over_48_kb():
    """j3d27pt's ``jc2`` adjoint at n = 512 (a summed kernel) has 49,096 B
    of dynamic shared memory, under 48 KB, and 256 static: the launcher
    must opt in to its dynamic bytes, so it counts the static ones in (the
    card refused the launch with ``cudaErrorInvalidValue`` when it opted
    in only above 48 KB of dynamic bytes); the stored kernel of the same
    plan has no static bytes and stays under 48 KB without it."""
    case = get_case("j3d27pt", 512)
    shapes = required_shapes(case.program)
    spec = next(s for s in adjoint_build(case.program).specs
                if s.input == "jc2")
    adj = adjoint_env_shapes(spec, case.program, shapes)
    tp = tile_program(spec.result().plan, adj, {k: "float32" for k in adj})
    assert tp.smem_bytes <= 48 * 1024 < tp.smem_bytes + 256
    src = render_cuda(tp, summed=True)
    assert "race_block_sum(" in src
    assert "  if (smem + 256 > 48 * 1024) {" in src
    stored = render_cuda(tp)
    assert "race_block_sum(" not in stored
    assert "  if (smem + 0 > 48 * 1024) {" in stored


#: phase 4's cells and the lane use of their step before its redesign (the
#: parent's geometry: one thread-strided sweep a box, the staged operands'
#: next planes, each aux plane and the body; elements over thread rounds),
#: rounded down at the sixth decimal
PARENT_LANE_USE = {
    ("j3d27pt", 512, "float32"): 0.899709,  # 9,904 / (43 x 256)
    ("poisson", 512, "float32"): 0.916807,  # 8,684 / (37 x 256)
    ("derivative", 256, "float64"): 0.754375,  # 4,828 / (25 x 256)
    ("hdifft_gm", 8192, "float32"): 0.828663,  # 6,152 / (29 x 256)
    ("j3d27pt", 512, "float16"): 0.899709,
    ("poisson", 512, "bfloat16"): 0.916807,
}


@pytest.mark.parametrize("name,n,dt", list(PARENT_LANE_USE))
def test_phase4_lane_use_is_kept(name, n, dt):
    """Phase 4's cells: the step's lane use is no lower than it was."""
    tp = _phase4(name, n, dt)
    assert tp.lane_use >= PARENT_LANE_USE[name, n, dt]


def _reference(name, lvl, dt, n):
    """(the reference's ``"xla"`` outputs as float64 numpy, the port's CPU
    env), on the same bits."""
    rc, pc = ref_case(name, n), get_case(name, n)
    if dt in ("float16", "bfloat16"):
        ref_env, env = _envs(pc, dt)
        return ({k: v.astype(np.float64)
                 for k, v in _ref_xla(rc, lvl, ref_env).items()}, env)
    npdt = np.dtype(dt).type
    env = build_env(pc, npdt)
    want = _ref_plan_output(rc, lvl, npdt, env)
    return ({k: np.asarray(v, np.float64) for k, v in want.items()},
            env_to_torch(env, "cpu"))


@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulator_on_the_step_matches_reference_xla(name, which):
    """(d) ``emulate`` on the step's schedule, at the chooser's plane tiles
    and at forced small tiles (rings wrap, segments end inside the
    extent), at a dtype per case that walks the four across the registry:
    stored within ``plan`` of the reference's ``"xla"``, and summed (each
    output's partials) within ``plan`` of the reference output's sum,
    scaled by the sum of its magnitudes."""
    n = SWEEP_SIZES[name]
    pc = get_case(name, n)
    lvl = 0 if which == "r0" else pc.reassociate
    dt = DTYPES[(list(CASES).index(name) + (which == "r0")) % 4]
    want, env = _reference(name, lvl, dt, n)
    tol = default_tolerances(dt)["plan"]
    shapes = required_shapes(pc.program)
    plan = repro_torch.race(pc.program, reassociate=lvl,
                            rewrite_div=pc.rewrite_div).plan
    for forced in ((0, 0, 0), (4, 2, 3)):
        tp = tile_program(plan, shapes, {k: dt for k in shapes}, *forced)
        got = emulate(tp, env)
        assert rel_err(got, want) <= tol, forced
        sums = emulate(tp, env, summed=True)
        for k, v in want.items():
            err = abs(float(sums[k].sum()) - float(v.sum()))
            assert err <= tol * max(float(np.abs(v).sum()), 1e-30), (
                forced, k)
