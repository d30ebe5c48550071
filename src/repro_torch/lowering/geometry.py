"""Own copy of ``repro/lowering/geometry.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Plan geometry for the stencil lowering engine.

This module is *pure plan analysis*: it imports no torch, so the capability
probe (``repro_torch.core.backend.probe_hopper``) can delegate here at zero
cost and — by construction — can never disagree with what the engine
actually lowers.  The window/envelope vocabulary below is the reference's
(it shaped Pallas BlockSpecs there); the Hopper kernel reads arrays through
affine indices and uses only the eligibility verdicts, read through
:func:`kernel_analysis`, and the exact one-sided ranges of :func:`aux_ranges`
(both at the end of this module, the port's own).

One :func:`analyze_plan` call classifies every base-array reference of a
plan and produces:

  * **eligibility**: structured :class:`~repro.lowering.facts.FallbackReason`
    entries for the genuinely out-of-model programs (malformed writes,
    zero-coefficient or fractional subscripts, per-array layout/stride
    inconsistencies, non-unit auxiliary references, scalar-only data);
  * **lowering facts**: which widening mechanisms the plan engages —
    non-2-D/3-D nest depth (N-D grid), negative coefficients
    (mirrored-origin windows: the array axis is flipped at prep time so the
    normalized coefficient is positive, ``b' = L-1-b``), repeated levels and
    constant dims (in-kernel index gather);
  * **geometry**: per-auxiliary tile extensions (how far each VMEM aux value
    must extend past the output tile, from its consumers' shifts, reverse
    topological) and per-array *offset envelopes* — for every window-class
    array and level, the min/max of ``b ∓ |a|·ext`` over all references in
    all contexts.  The envelopes are kept in raw (unflipped) coordinates so
    the analysis stays shape-independent; ``repro.lowering.blocks`` maps
    them through the mirror (``off' = (L-1) - off``) once shapes are known.

Window positioning generalizes the original symmetric-halo math: instead of
padding ``p = max(|a|·ext + |b|)`` on both sides, each level keeps an
asymmetric ``[off_lo, off_hi]`` envelope.  Ordinary small offsets reproduce
the old windows; mirrored references (whose normalized offsets sit near the
far end of the axis) recenter instead of padding the whole array.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from fractions import Fraction

from ..core.depgraph import Plan, _aux_ref_shifts
from ..core.ir import Expr, Program, Ref, expr_refs

from .facts import (R_CONSTANT_DIM, R_DEPTH, R_FRACTIONAL_OFFSET,
                    R_INCONSISTENT_LAYOUT, R_LHS_FORM, R_MIXED_STRIDE,
                    R_NEGATIVE_COEF, R_NO_BASE_ARRAY, R_REPEATED_LEVEL,
                    R_SCALAR_AUX, R_STRIDED_AUX, R_ZERO_COEF, FallbackReason,
                    LoweringError, LoweringFact)

#: array classification (ArrayInfo.kind)
K_WINDOW = "window"  # blocked halo-exchange windows (the fast path)
K_GATHER = "gather"  # whole-array operand + in-kernel index gather


@dataclass
class ArrayInfo:
    """Lowering-relevant shape of one base array (consistent across refs)."""

    name: str
    kind: str  # K_WINDOW | K_GATHER
    ndim: int
    dims: tuple  # per array dim: its loop level (0 = constant dim)
    levels: tuple  # referenced loop levels, ascending
    # window-class only ------------------------------------------------------
    perm: tuple = ()  # array dim -> ascending-level order (argsort of dims)
    coefs: dict = field(default_factory=dict)  # level -> |a|
    signs: dict = field(default_factory=dict)  # level -> +1 | -1
    #: raw (unflipped) per-level offset envelopes over every reference in
    #: every context: off_lo = min(b - |a|*ext), off_hi = max(b + |a|*ext)
    off_lo: dict = field(default_factory=dict)
    off_hi: dict = field(default_factory=dict)

    @property
    def mirrored_levels(self) -> tuple:
        return tuple(l for l in self.levels if self.signs.get(l, 1) < 0)


@dataclass
class LoweringAnalysis:
    """Everything the engine (and the probe) knows about one plan."""

    plan: Plan
    depth: int
    eligible: bool
    reasons: tuple  # FallbackReason, empty when eligible
    facts: tuple  # LoweringFact — mechanisms engaged, empty on plain 2-D/3-D
    arrays: dict  # name -> ArrayInfo (empty when ineligible)
    ext: dict  # aux name -> per-level tile extension (output coords)

    def explain(self) -> str:
        if self.eligible:
            return "eligible"
        return "; ".join(str(r) for r in self.reasons)


def _int_or_none(b):
    f = Fraction(b)
    return int(f) if f.denominator == 1 else None


def _scan_ref(r: Ref, reasons: list, where: str) -> None:
    """Per-reference syntax checks shared by both array classes."""
    for s in r.subs:
        if _int_or_none(s.b) is None:
            reasons.append(FallbackReason(
                R_FRACTIONAL_OFFSET,
                f"{r.name} has fractional offset {s.b} ({where})"))
        if s.s != 0 and s.a == 0:
            reasons.append(FallbackReason(
                R_ZERO_COEF,
                f"{r.name} has a zero-coefficient subscript ({where})"))


def _is_gather(r: Ref) -> bool:
    lvls = [s.s for s in r.subs if s.s != 0]
    return any(s.s == 0 for s in r.subs) or len(set(lvls)) != len(lvls)


def analyze_plan(plan: Plan) -> LoweringAnalysis:
    """Classify a plan for the stencil lowering engine (memoized
    per plan instance — the serving path probes on every ``auto`` call)."""
    cached = getattr(plan, "_lowering_analysis", None)
    if cached is not None:
        return cached
    a = _analyze(plan)
    plan._lowering_analysis = a
    return a


def _analyze(plan: Plan) -> LoweringAnalysis:
    prog = plan.program
    m = prog.depth
    reasons: list = []
    facts: list = []
    aux_names = {a.name for a in plan.aux_order}
    all_levels = set(range(1, m + 1))

    # ---- auxiliaries must carry at least one loop level --------------------
    # (a rank-0 aux — fully loop-invariant — has no tile geometry; the
    # emitter's scalar path only knows env scalars.  Adjoint-stencil plans
    # are the first to produce these.)
    for aux in plan.aux_order:
        if not aux.levels:
            reasons.append(FallbackReason(
                R_SCALAR_AUX,
                f"auxiliary {aux.name} is loop-invariant (rank 0)"))

    # ---- output form: every lhs sweeps all levels, unit, distinct ----------
    for st in plan.body:
        lhs_levels = [s.s for s in st.lhs.subs]
        if (set(lhs_levels) != all_levels
                or len(lhs_levels) != len(set(lhs_levels))
                or any(s.a != 1 for s in st.lhs.subs)):
            reasons.append(FallbackReason(
                R_LHS_FORM,
                f"output {st.lhs.name} must sweep all {m} levels with "
                f"unit-coefficient distinct subscripts"))

    # ---- collect references per base array; syntax + aux checks ------------
    refs_by_array: dict = {}  # name -> [(Ref, context, where)]

    def scan(e: Expr, ctx: str, where: str) -> None:
        for r in expr_refs(e):
            if not r.subs:
                continue
            if r.name in aux_names:
                lvls = [s.s for s in r.subs]
                if (any(s.a != 1 or s.s == 0 for s in r.subs)
                        or len(set(lvls)) != len(lvls)):
                    reasons.append(FallbackReason(
                        R_STRIDED_AUX,
                        f"auxiliary {r.name} referenced with non-unit or "
                        f"repeated subscripts ({where})"))
                if any(_int_or_none(s.b) is None for s in r.subs):
                    reasons.append(FallbackReason(
                        R_FRACTIONAL_OFFSET,
                        f"auxiliary {r.name} has a fractional offset "
                        f"({where})"))
                continue
            _scan_ref(r, reasons, where)
            refs_by_array.setdefault(r.name, []).append((r, ctx, where))

    for st in plan.body:
        scan(st.rhs, "__main__", f"main statement {st.lhs.name}")
    for aux in plan.aux_order:
        scan(plan.aux_exprs[aux.name], aux.name, f"aux {aux.name}")

    # ---- classify arrays; window-class consistency -------------------------
    arrays: dict = {}
    for nm, refs in refs_by_array.items():
        ndim0 = len(refs[0][0].subs)
        if any(len(r.subs) != ndim0 for r, _, _ in refs):
            reasons.append(FallbackReason(
                R_INCONSISTENT_LAYOUT,
                f"{nm} is referenced with different ranks"))
            continue
        gather = any(_is_gather(r) for r, _, _ in refs)
        lvl_union = sorted({s.s for r, _, _ in refs for s in r.subs
                            if s.s != 0})
        if gather:
            trigger = []
            if any(any(s.s == 0 for s in r.subs) for r, _, _ in refs):
                trigger.append((R_CONSTANT_DIM, "constant dims"))
            if any(len({s.s for s in r.subs if s.s != 0})
                   != len([s for s in r.subs if s.s != 0])
                   for r, _, _ in refs):
                trigger.append((R_REPEATED_LEVEL, "repeated loop levels"))
            for code, what in trigger:
                facts.append(LoweringFact(
                    code, f"{nm}: {what} lowered via in-kernel index "
                          f"gather"))
            arrays[nm] = ArrayInfo(nm, K_GATHER, ndim0,
                                   tuple(s.s for s in refs[0][0].subs),
                                   tuple(lvl_union))
            continue
        dims0 = tuple(s.s for s in refs[0][0].subs)
        coefs: dict = {}
        ok = True
        for r, _, where in refs:
            dims = tuple(s.s for s in r.subs)
            if dims != dims0:
                reasons.append(FallbackReason(
                    R_INCONSISTENT_LAYOUT,
                    f"{nm} is referenced with different dim->level "
                    f"layouts ({where})"))
                ok = False
                break
            for s in r.subs:
                prev = coefs.setdefault(s.s, s.a)
                if prev != s.a:
                    reasons.append(FallbackReason(
                        R_MIXED_STRIDE,
                        f"{nm} is referenced with different per-level "
                        f"coefficients ({where})"))
                    ok = False
            if not ok:
                break
        if not ok:
            continue
        for lvl, a in sorted(coefs.items()):
            if a < 0:
                facts.append(LoweringFact(
                    R_NEGATIVE_COEF,
                    f"{nm}: negative coefficient at level {lvl} lowered "
                    f"via a mirrored-origin window"))
        arrays[nm] = ArrayInfo(
            nm, K_WINDOW, ndim0, dims0, tuple(sorted(dims0)),
            perm=tuple(sorted(range(ndim0), key=lambda k: dims0[k])),
            coefs={l: abs(a) for l, a in coefs.items()},
            signs={l: (1 if a > 0 else -1) for l, a in coefs.items()})

    # scalar-aux reasons don't mask this one: a scalar-only program usually
    # materializes its loop-invariant subexpressions as rank-0 auxiliaries,
    # and callers key off no-base-array to explain the fallback.
    if (plan.body and not refs_by_array
            and all(r.code == R_SCALAR_AUX for r in reasons)):
        reasons.append(FallbackReason(
            R_NO_BASE_ARRAY,
            "no array operand on any right-hand side (scalar-only data)"))

    if m != 2 and m != 3:
        facts.append(LoweringFact(
            R_DEPTH,
            f"depth-{m} nest lowered by the N-D grid (level-1 tiling for "
            f"1-D, outer-level tiling beyond 3-D)"))

    # dedupe while keeping first-seen order
    def _uniq(items):
        out, seen = [], set()
        for it in items:
            key = (it.code, it.detail)
            if key not in seen:
                seen.add(key)
                out.append(it)
        return tuple(out)

    reasons = _uniq(reasons)
    facts = _uniq(facts)
    if reasons:
        return LoweringAnalysis(plan, m, False, reasons, facts, {}, {})

    # ---- aux tile extensions (reverse-topo: consumers before producers) ----
    ext = {a.name: [0] * m for a in plan.aux_order}

    def visit_consumer(expr: Expr, own_ext):
        for nm, sh in _aux_ref_shifts(expr, aux_names):
            for lvl in range(1, m + 1):
                need = abs(sh.get(lvl, 0)) + own_ext[lvl - 1]
                ext[nm][lvl - 1] = max(ext[nm][lvl - 1], need)

    for st in plan.body:
        visit_consumer(st.rhs, [0] * m)
    for a in reversed(plan.aux_order):
        visit_consumer(plan.aux_exprs[a.name], ext[a.name])
    ext = {k: tuple(v) for k, v in ext.items()}

    # ---- per-array raw offset envelopes over every (ref, context) ----------
    def visit_base(expr: Expr, own_ext):
        for r in expr_refs(expr):
            if r.name in aux_names or not r.subs:
                continue
            info = arrays[r.name]
            if info.kind != K_WINDOW:
                continue
            for s in r.subs:
                b = _int_or_none(s.b)
                reach = abs(s.a) * own_ext[s.s - 1]
                info.off_lo[s.s] = min(info.off_lo.get(s.s, b - reach),
                                       b - reach)
                info.off_hi[s.s] = max(info.off_hi.get(s.s, b + reach),
                                       b + reach)

    for st in plan.body:
        visit_base(st.rhs, [0] * m)
    for a in plan.aux_order:
        visit_base(plan.aux_exprs[a.name], ext[a.name])

    return LoweringAnalysis(plan, m, True, (), facts, arrays, ext)


def offset_envelopes(plan: Plan):
    """Stable envelope API for consumers outside the lowering engine.

    Returns ``{array name: {level: (off_lo, off_hi)}}`` over the plan's
    *window-class* base arrays — per referenced level, the min/max of
    ``b ∓ |a|·ext`` across every reference in every context (auxiliary
    reach included), in raw (unflipped) array coordinates — or ``None``
    when the plan is geometry-ineligible, in which case
    ``analyze_plan(plan).reasons`` carries the structured why.

    Note these are the *plan's* read envelopes: auxiliary range propagation
    keeps rectangular hulls, so they over-approximate the reads that
    actually influence the interior outputs (the slop positions hold
    partial sums never consumed by the main statements).  Consumers sizing
    data movement by what *matters* — the sharded execution layer
    (:mod:`repro.shard`) sizing per-shard slabs — use
    :func:`program_envelopes` instead: RACE preserves semantics, so every
    influencing auxiliary value is a partial sum of original-program terms
    at the same iteration point, and the program's direct offsets bound the
    influencing reach exactly.  Gather-class arrays have no window form and
    do not appear; their levels are reported by
    ``analyze_plan(plan).arrays[name].levels``.
    """
    a = analyze_plan(plan)
    if not a.eligible:
        return None
    return {nm: {l: (info.off_lo[l], info.off_hi[l]) for l in info.levels}
            for nm, info in a.arrays.items() if info.kind == K_WINDOW}


class _ProgramShim:
    """Just enough Plan surface for ``_analyze`` to classify a bare Program:
    the body is the program's own statements and there are no auxiliaries,
    so the resulting envelopes are the *direct* per-reference offsets."""

    def __init__(self, program: Program):
        self.program = program
        self.body = program.body
        self.aux_order = ()
        self.aux_exprs: dict = {}


def analyze_program(program: Program) -> LoweringAnalysis:
    """`analyze_plan` over a program's own statements (no plan, no aux).

    Same classification vocabulary — window/gather kinds, per-level
    coefficients and signs, structured ineligibility reasons — but the
    ``off_lo``/``off_hi`` envelopes are the program's direct read offsets,
    i.e. the exact influencing reach of *any* RACE plan derived from it.
    Memoized on the program instance."""
    cached = getattr(program, "_program_analysis", None)
    if cached is None:
        cached = _analyze(_ProgramShim(program))
        object.__setattr__(program, "_program_analysis", cached)
    return cached


def program_envelopes(program: Program):
    """``{array: {level: (off_lo, off_hi)}}`` of a program's direct reads
    over its window-class arrays, or ``None`` when geometry-ineligible
    (``analyze_program(program).reasons`` says why).

    This is the envelope the sharded execution layer (:mod:`repro.shard`)
    sizes halos from: the tightest correct slab extension, independent of
    which plan (which auxiliary decomposition) executes the program."""
    a = analyze_program(program)
    if not a.eligible:
        return None
    return {nm: {l: (info.off_lo[l], info.off_hi[l]) for l in info.levels}
            for nm, info in a.arrays.items() if info.kind == K_WINDOW}


def aux_shift(ref: Ref) -> dict:
    """{level: integer shift} of a unit-coefficient auxiliary reference."""
    sh = {}
    for s in ref.subs:
        if s.a != 1 or s.s == 0:
            raise ValueError("strided aux references unsupported")
        b = _int_or_none(s.b)
        if b is None:
            raise ValueError("fractional aux offsets unsupported")
        sh[s.s] = b
    return sh


def ref_affine(ref: Ref) -> dict:
    """{level: (a, b)} of a distinct-level affine reference (raw signs)."""
    info = {}
    for s in ref.subs:
        if s.s == 0 or s.s in info:
            raise ValueError("constant or repeated dims have no window form")
        b = _int_or_none(s.b)
        if b is None:
            raise ValueError("fractional offsets unsupported")
        info[s.s] = (s.a, b)
    return info


def plan_geometry(plan: Plan):
    """Back-compat wrapper for the pre-engine ``plan_geometry`` API.

    Returns the historical ``(ext, perms, levels_of, coefs, pad_in)`` tuple
    for plans whose arrays are all positive-stride window class; raises
    :class:`LoweringError` (a ``ValueError``) otherwise, like the old code
    raised on anything outside the 2-D/3-D positive-coefficient envelope.
    New code should call :func:`analyze_plan` instead.
    """
    a = analyze_plan(plan)
    if not a.eligible:
        raise LoweringError(a.reasons)
    bad = [i for i in a.arrays.values()
           if i.kind != K_WINDOW or i.mirrored_levels]
    if bad:
        raise LoweringError(
            (), f"arrays {sorted(i.name for i in bad)} need the gather or "
                f"mirrored-window mechanisms; use analyze_plan()")
    perms = {nm: i.perm for nm, i in a.arrays.items()}
    levels_of = {nm: i.levels for nm, i in a.arrays.items()}
    coefs = {nm: dict(i.coefs) for nm, i in a.arrays.items()}
    pad_in = {}
    for nm, i in a.arrays.items():
        p = [0] * a.depth
        for l in i.levels:
            p[l - 1] = max(i.off_hi[l], -i.off_lo[l], 0)
        pad_in[nm] = tuple(p)
    return a.ext, perms, levels_of, coefs, pad_in


# ---------------------------------------------------------------------------
# the Hopper kernel's view of a plan (the port's own; not in the reference)
# ---------------------------------------------------------------------------


def kernel_memo(plan: Plan) -> dict:
    """What the Hopper kernel derives from a plan, memoized per plan
    instance (the probe asks on every ``"auto"`` call): its
    :func:`kernel_analysis` under ``"analysis"`` and the tile choices of
    :func:`~.blocks.choose_tile` under their arguments."""
    return plan.__dict__.setdefault("_kernel_memo", {})


def kernel_analysis(plan: Plan) -> LoweringAnalysis:
    """:func:`analyze_plan` as the Hopper kernel reads it.

    Equal to it, except that a plan whose only reasons are ``scalar-aux`` is
    eligible when every rank-0 auxiliary is built from scalars, constants
    and other rank-0 auxiliaries alone: it is then analysed without them
    (``arrays`` and ``ext`` leave them out; the kernel evaluates them once
    per thread into registers).  :func:`analyze_plan` itself keeps
    reporting ``scalar-aux`` as the reference does.  Memoized in
    :func:`kernel_memo`."""
    memo = kernel_memo(plan)
    if "analysis" not in memo:
        a = analyze_plan(plan)
        scalar = [x for x in plan.aux_order if not x.levels]
        if (not a.eligible and a.reasons
                and all(r.code == R_SCALAR_AUX for r in a.reasons)
                and all(not r.subs for x in scalar
                        for r in expr_refs(plan.aux_exprs[x.name]))):
            ranked = [x for x in plan.aux_order if x.levels]
            a = replace(_analyze(replace(plan, aux_order=ranked)), plan=plan)
        memo["analysis"] = a
    return memo["analysis"]


def aux_ranges(plan: Plan) -> dict:
    """Exact one-sided aux ranges: ``{aux name: ((lo, hi), ...)}``, one pair
    per loop level, the shifts relative to the output point at which each
    auxiliary of rank > 0 must exist so that the body can be evaluated at
    ``(0, ..., 0)``.

    The consumers' shifts are propagated backward from the body in reverse
    topological order (consumers before producers): an aux's range is the
    hull, over every reference to it, of the consumer's range moved by the
    reference's shift.  Levels an aux does not cover stay ``(0, 0)``.  The
    ranges lie inside the symmetric ``±ext`` box of :func:`analyze_plan`,
    which applies the largest absolute shift on both sides."""
    m = plan.program.depth
    names = {a.name for a in plan.aux_order if a.levels}
    hull: dict = {}

    def visit(expr: Expr, own) -> None:
        for nm, sh in _aux_ref_shifts(expr, names):
            moved = [(lo + sh.get(l, 0), hi + sh.get(l, 0))
                     for l, (lo, hi) in enumerate(own, 1)]
            cur = hull.get(nm)
            hull[nm] = moved if cur is None else [
                (min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(cur, moved)]

    for st in plan.body:
        visit(st.rhs, [(0, 0)] * m)
    for a in reversed(plan.aux_order):
        if a.name in hull:
            visit(plan.aux_exprs[a.name], hull[a.name])
    return {a.name: tuple(hull.get(a.name, [(0, 0)] * m)[l - 1]
                          if l in a.levels else (0, 0)
                          for l in range(1, m + 1))
            for a in plan.aux_order if a.levels}
