"""The streaming schedule of the Hopper stencil kernel
(``repro_torch/lowering/blocks.py``): exact one-sided aux ranges, the stream
level, the CUDA rendering of the march, and a replay of the march that checks
every shifted read of an aux or operand plane against the ring slot it
reads, over the registry's plans and their adjoint plans at the chooser's
tiles and at random forced plane tiles and segments."""
import functools

import numpy as np
import pytest
pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race
from repro.lowering import analyze_plan as ref_analyze_plan

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
from repro_torch.core.backend import probe_hopper
from repro_torch.core.codegen import required_shapes
from repro_torch.core.depgraph import _aux_ref_shifts
from repro_torch.lowering.blocks import BODY
from repro_torch.lowering.emit import specialize_stencil, tile_program
from repro_torch.lowering.geometry import (analyze_plan, aux_ranges,
                                           kernel_analysis)
from repro_torch.testing import SWEEP_SIZES

pytestmark = pytest.mark.port


@functools.lru_cache(maxsize=None)
def _plans(name):
    """``(plan, shapes)`` of the case's forward plans (reassociate 0 and
    default) and of every adjoint plan the kernel's probe admits."""
    case = get_case(name, SWEEP_SIZES[name])
    shapes = required_shapes(case.program)
    out = []
    for lvl in sorted({0, case.reassociate}):
        res = repro_torch.race(case.program, reassociate=lvl,
                               rewrite_div=case.rewrite_div)
        out.append((res.plan, shapes))
    for spec in adjoint_build(case.program).specs:
        plan = spec.result().plan
        if probe_hopper(plan, ["float32"]).eligible:
            out.append((plan, adjoint_env_shapes(spec, case.program, shapes)))
    return out


def _program(plan, shapes, rows=0, cols=0, inner=0):
    return tile_program(plan, shapes, {k: "float32" for k in shapes}, rows,
                        cols, inner)


def _replay(tp) -> int:
    """Replay one block's march on plane numbers (relative to the segment's
    first output plane).  Each ring slot holds the plane last written into
    it, with the step and barrier phase of the write; the operand planes of
    the next step count as written while a step runs (their loads are in
    flight).  Every read must find, in the slot it reads, the
    plane its reference needs at that step, written in an earlier step or
    an earlier phase of this one; its in-plane window must lie inside the
    ring's box at the reference's offset.  Returns the number of reads
    checked."""
    g = tp.geometry
    s, m = g.s_level, g.m
    held = [[None] * r.depth for r in g.rings]
    reads_of: dict = {}
    for (ctx, ref), rd in g.reads.items():
        reads_of.setdefault(ctx, []).append((ref, rd))
    body_widths = tuple(g.tile[l - 1] if l in g.order else 1
                        for l in range(1, m + 1))
    checked = [0]

    def offsets(ref) -> dict:
        if ref.name in {r.name for r in g.rings if not r.operand}:
            return {lv: int(sh) for lv, sh in
                    _aux_ref_shifts(ref, {ref.name})[0][1].items()}
        return {sub.s: int(sub.b) for sub in ref.subs}

    def check(ctx, k, phase):
        lo, lead, widths = ((0,) * m, 0, body_widths) if ctx == BODY else (
            g.rings[ctx].lo, g.rings[ctx].lead, g.rings[ctx].widths)
        for ref, rd in reads_of.get(ctx, ()):
            r = g.rings[rd.ring]
            off = offsets(ref)
            slot = (k - g.k0 - rd.back) % r.depth if r.streamed else 0
            plane, step, wphase = held[rd.ring][slot]
            if r.streamed:
                assert plane == k + lead + off[s], (ref, rd)
            assert step < k or wphase < phase, (ref, rd)
            for l in g.order:
                if l in r.levels:
                    assert rd.offset[l - 1] == lo[l - 1] + off[l] - r.lo[
                        l - 1]
                    assert 0 <= rd.offset[l - 1]
                    assert rd.offset[l - 1] + widths[l - 1] <= r.widths[
                        l - 1]
            checked[0] += 1

    def write(i, k, step, phase):
        r = g.rings[i]
        assert k >= r.start
        held[i][(k - g.k0) % r.depth] = (k + r.lead, step, phase)

    operands = [i for i, r in enumerate(g.rings) if r.operand]
    n_aux = len(tp.aux_exprs)
    for i in range(n_aux):  # boxes once per block, a barrier after each
        if not g.rings[i].streamed:
            check(i, g.k0 - 1, i)
            held[i][0] = (None, g.k0 - 1, i)
    for i in operands:
        if g.rings[i].start <= g.k0:
            write(i, g.k0, g.k0 - 1, -1)
    last = max([r.phase for r in g.rings], default=0) + 1
    for k in range(g.k0, g.seg):
        for i in operands:
            if g.rings[i].start <= k + 1 < g.seg:
                write(i, k + 1, k, last + 1)
        for i in sorted(range(n_aux), key=lambda i: g.rings[i].phase):
            r = g.rings[i]
            if r.streamed and k >= r.start:
                check(i, k, r.phase)
                write(i, k, k, r.phase)
        if k >= 0:
            check(BODY, k, last)
    return checked[0]


@pytest.mark.parametrize("name", list(CASES))
def test_march_reads_every_plane_at_the_chooser_tiles(name):
    for plan, shapes in _plans(name):
        tp = _program(plan, shapes)
        n = _replay(tp)
        assert n >= len(tp.geometry.reads) * (tp.geometry.s_level != 0)


@settings(max_examples=60, deadline=None)
@given(name=st.sampled_from(list(CASES)), which=st.integers(0, 8),
       rows=st.integers(0, 5), cols=st.integers(0, 4),
       inner=st.integers(0, 6))
def test_march_reads_every_plane_at_forced_tiles(name, which, rows, cols,
                                                 inner):
    """Forced plane tiles and segments (0: the chooser's), many rings
    wrapping and segments ending inside the extent, forward and adjoint."""
    plans = _plans(name)
    plan, shapes = plans[which % len(plans)]
    _replay(_program(plan, shapes, rows, cols, inner))


@pytest.mark.parametrize("name", list(CASES))
def test_exact_ranges_are_the_consumers_hull(name):
    """Each aux range is the hull of its consumers' ranges moved by their
    shifts (the body reads at 0), and lies inside the symmetric ``±ext``
    box."""
    for plan, _ in _plans(name):
        rng = aux_ranges(plan)
        ext = kernel_analysis(plan).ext
        names = set(rng)
        hull: dict = {}
        m = plan.program.depth
        consumers = [(st.rhs, ((0, 0),) * m) for st in plan.body]
        consumers += [(plan.aux_exprs[a.name], rng[a.name])
                      for a in plan.aux_order if a.name in names]
        for expr, own in consumers:
            for nm, sh in _aux_ref_shifts(expr, names):
                for l in sh:
                    lo, hi = own[l - 1][0] + sh[l], own[l - 1][1] + sh[l]
                    cur = hull.get((nm, l), (lo, hi))
                    hull[(nm, l)] = (min(cur[0], lo), max(cur[1], hi))
        for a in plan.aux_order:
            if not a.levels:
                continue
            for l in range(1, m + 1):
                lo, hi = rng[a.name][l - 1]
                if l in a.levels:
                    assert (lo, hi) == hull[(a.name, l)]
                    assert -ext[a.name][l - 1] <= lo <= hi <= ext[a.name][
                        l - 1]
                else:
                    assert (lo, hi) == (0, 0)


def test_exact_ranges_pin_j3d27pt():
    """``aa_0_0`` has the symmetric extension 2 on each level (the
    reference's ``ext``) but is read only at ``[0, 2]`` on each."""
    case = get_case("j3d27pt", 10)
    plan = repro_torch.race(case.program, reassociate=case.reassociate).plan
    ref_plan = ref_race(ref_case("j3d27pt", 10).program,
                        reassociate=case.reassociate).plan
    assert ref_analyze_plan(ref_plan).ext["aa_0_0"] == (2, 2, 2)
    assert analyze_plan(plan).ext["aa_0_0"] == (2, 2, 2)
    assert aux_ranges(plan)["aa_0_0"] == ((0, 2), (0, 2), (0, 2))


@pytest.mark.parametrize("name,x,s", [("j3d27pt", 1, 3), ("hdifft_gm", 1, 2),
                                      ("blocked4d", 4, 1), ("diag2d", 2, 1),
                                      ("smooth1d", 1, 0)])
def test_stream_level_is_the_outermost_dimension(name, x, s):
    """Fortran-ordered 3-D (``u[i,k,j]`` under loops ``(j,k,i)``) streams
    level 3 under an x-level 1; C-ordered nests stream level 1; a 1-D nest
    has no stream level (a march of one step)."""
    plan, shapes = _plans(name)[0]
    g = _program(plan, shapes).geometry
    assert (g.x_level, g.s_level) == (x, s)
    assert g.order[0] == x and s not in g.order
    if not s:
        assert g.seg == 1 and g.k0 == 0
        assert not any(r.streamed for r in g.rings)


@pytest.mark.parametrize("name,dt,most", [("j3d27pt", "float32", 12.3),
                                          ("poisson", "float32", 7.3),
                                          ("derivative", "float64", 50.1)])
def test_full_size_aux_evaluations_per_point(name, dt, most):
    """At the smoke run's sizes the march evaluates fewer aux values per
    output point than a 3-D tile with exact ranges would (the bounds), and
    at least one per aux."""
    case = get_case(name, 512 if name != "derivative" else 256)
    plan = repro_torch.race(case.program, reassociate=case.reassociate).plan
    shapes = required_shapes(case.program)
    tp = tile_program(plan, shapes, {k: dt for k in shapes})
    assert len(tp.aux_exprs) <= tp.aux_evals_per_point < most


def test_render_cuda_marches_with_staged_planes():
    """One march loop from the warm-up step; the staged operand goes
    through ``race_stage`` (``cp.async`` for float32); a ring's slot base
    is rotated once per step; a
    mirrored operand keeps its guarded global load."""
    case = get_case("j3d27pt", 64)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    shapes = required_shapes(case.program)
    spec = specialize_stencil(res.plan, shapes, {k: "float32" for k in shapes})
    g, src = spec.tp.geometry, spec.source
    assert src.count(f"for (int k = {g.k0}; k < {g.seg}; ++k)") == 1
    assert "race_stage(" in src and "race_cp_async_wait<" in src
    march = src.split(f"for (int k = {g.k0};")[1]
    bases = [ln for ln in march.splitlines()
             if ln.strip().startswith(("const int b", "r"))]
    assert bases and not any("%" in ln for ln in bases)
    md = get_case("mirror_deriv", 14)
    res = repro_torch.race(md.program, reassociate=md.reassociate)
    shapes = required_shapes(md.program)
    spec = specialize_stencil(res.plan, shapes, {k: "float64" for k in shapes})
    assert not any(r.operand for r in spec.tp.geometry.rings)
    assert "race_stage(" not in spec.source


@pytest.mark.parametrize("name", ["j3d27pt", "gaussian", "mirror_deriv"])
def test_rank0_aux_are_registers(name):
    """The ``u`` adjoint's rank-0 aux (``scalar-aux`` in the reference)
    become one register per thread at the top of the kernel, and the tile
    program leaves them out of the rings and the scalars."""
    case = get_case(name, SWEEP_SIZES[name])
    spec = next(s for s in adjoint_build(case.program).specs
                if s.input == "u")
    plan = spec.result().plan
    rank0 = [a.name for a in plan.aux_order if not a.levels]
    assert rank0
    shapes = adjoint_env_shapes(spec, case.program,
                                required_shapes(case.program))
    tp = tile_program(plan, shapes, {k: "float64" for k in shapes})
    assert [nm for nm, _ in tp.scalar_aux] == rank0
    assert not set(rank0) & set(tp.scalars)
    assert not set(rank0) & {r.name for r in tp.geometry.rings}
    src = specialize_stencil(plan, shapes,
                             {k: "float64" for k in shapes}).source
    for k, nm in enumerate(rank0):
        assert f"const acc_t ra{k} = " in src and f"// {nm}" in src
    _replay(tp)
    assert np.isfinite(tp.aux_evals_per_point)
