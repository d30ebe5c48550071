"""Own copy of ``repro/core/depgraph.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Auxiliary-array dependency graph, range propagation, range circles, and
array contraction (paper Section 6.2).

The dependency DAG has consumers pointing at producers; ranges propagate in
topological order from the original statements (which inherit the original
loop ranges) down to every auxiliary array: a consumer iterating level ``l``
over ``[lo, hi]`` that references ``aa[.., i_l + d, ..]`` needs ``aa`` over
``[lo + d, hi + d]``; an aux's range is the hull over all its consumers.

Contraction rules realized here (DESIGN.md section 2 maps them to TPU):
  1. refcount == 1  ->  inline the representative expression (never stored);
  2. all refs zero-shift and consumers in the same range circle  ->  'local'
     (compute-once SSA value; the scalar of the paper's Fig 2);
  3. per-level reuse *windows* (max shift - min shift + 1): a window of w
     along a non-innermost level means the aux can live as a w-slice rolling
     buffer when loops stream that level — the paper's double buffer.  The
     whole-array JAX evaluator ignores windows (XLA fuses); the Pallas
     executor allocates VMEM scratch of the windowed size.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from fractions import Fraction

from .detect import AuxDef, Transformed
from .ir import Expr, Program, Ref, Stmt, count_ops, expr_refs, substitute


@dataclass
class Plan:
    """Post-contraction executable plan (consumed by codegen + Pallas)."""

    program: Program
    body: tuple  # final main statements (post-inlining)
    aux_order: list  # AuxDefs to materialize, topological (producers first)
    aux_exprs: dict  # name -> definition expr (post-inlining)
    ranges: dict  # name -> {level: (lo, hi)}
    windows: dict  # name -> {level: reuse window (int)}
    refcounts: dict  # name -> consumer reference count (pre-inline)
    inlined: set
    local: set  # rule-2 "scalar" auxs
    circles: list  # [(range_key, [aux names])] in emission order
    rounds: int = 0

    def all_defs(self):
        return [(a, self.aux_exprs[a.name]) for a in self.aux_order]


def _aux_ref_shifts(e: Expr, aux_names) -> list:
    """(name, {level: int shift}) for every aux reference in e."""
    out = []
    for r in expr_refs(e):
        if r.name in aux_names:
            out.append((r.name, {s.s: int(s.b) for s in r.subs if s.s != 0}))
    return out


def finalize(t: Transformed, contraction: bool = True) -> Plan:
    program = t.program
    aux_by_name = {a.name: a for a in t.aux}
    names = set(aux_by_name)

    # ---- reference counts over main body + aux definitions -----------------
    def refcount():
        c: Counter = Counter()
        for st in body:
            for n, _ in _aux_ref_shifts(st.rhs, names):
                c[n] += 1
        for nm in names:
            for n, _ in _aux_ref_shifts(exprs[nm], names):
                c[n] += 1
        return c

    body = t.body
    exprs = {a.name: a.expr for a in t.aux}

    # ---- rule 1: inline single-reference auxs (iterate to fixpoint) --------
    # Never inline into a *larger* iteration space: a hoisted loop-invariant
    # aux (fewer levels than its consumer) would get recomputed per extra
    # iteration, undoing the hoist (e.g. the RoPE layer-loop cache).
    all_levels = set(range(1, program.depth + 1))

    def _consumer_levels(nm: str) -> set:
        for st in body:
            if any(n == nm for n, _ in _aux_ref_shifts(st.rhs, {nm})):
                return set(all_levels)
        for other in names:
            if other != nm and any(
                n == nm for n, _ in _aux_ref_shifts(exprs[other], {nm})
            ):
                return set(aux_by_name[other].levels)
        return set()

    inlined: set = set()
    if contraction:
        while True:
            counts = refcount()
            once = {
                n for n in names
                if counts[n] == 1
                and not (set(aux_by_name[n].levels) < _consumer_levels(n))
            }
            if not once:
                break
            table = {n: exprs[n] for n in once}
            body = tuple(Stmt(st.lhs, substitute(st.rhs, table)) for st in body)
            for nm in list(names):
                if nm not in once:
                    exprs[nm] = substitute(exprs[nm], table)
            names -= once
            inlined |= once
            for nm in once:
                exprs.pop(nm)

    refcounts = refcount()

    # ---- topological order (producers first = aux creation order works,    -
    # ---- but recompute properly so inlining holes don't matter) ------------
    live = [a for a in t.aux if a.name in names]
    deps = {
        a.name: [n for n, _ in _aux_ref_shifts(exprs[a.name], names)] for a in live
    }
    order: list = []
    seen: set = set()

    def visit(nm):
        if nm in seen:
            return
        seen.add(nm)
        for d in deps[nm]:
            visit(d)
        order.append(nm)

    for a in live:
        visit(a.name)
    aux_order = [aux_by_name[n] for n in order]

    # ---- range propagation: consumers before producers ---------------------
    full = program.ranges()
    ranges: dict = {n: {} for n in names}
    shifts_seen: dict = {n: {} for n in names}  # level -> [shifts] for windows

    def need(nm: str, lvl: int, lo: int, hi: int):
        cur = ranges[nm].get(lvl)
        ranges[nm][lvl] = (lo, hi) if cur is None else (min(cur[0], lo), max(cur[1], hi))

    def consume(consumer_ranges, e: Expr):
        for n, sh in _aux_ref_shifts(e, names):
            for lvl in aux_by_name[n].levels:
                d = sh.get(lvl, 0)
                lo, hi = consumer_ranges[lvl]
                need(n, lvl, lo + d, hi + d)
                shifts_seen[n].setdefault(lvl, []).append(d)

    for st in body:
        consume(full, st.rhs)
    for nm in reversed(order):  # consumers (later defs) before producers
        consume(ranges[nm], exprs[nm])

    # ---- range circles (identical range maps) -------------------------------
    def range_key(nm):
        return tuple(sorted(ranges[nm].items()))

    circle_map: dict = {}
    for nm in order:
        circle_map.setdefault(range_key(nm), []).append(nm)
    circles = list(circle_map.items())

    # ---- rule 2: same-circle zero-shift 'scalars' ---------------------------
    local: set = set()
    if contraction:
        consumers_of: dict = {n: [] for n in names}
        for st in body:
            for n, sh in _aux_ref_shifts(st.rhs, names):
                consumers_of[n].append(("__main__", sh))
        for nm in names:
            for n, sh in _aux_ref_shifts(exprs[nm], names):
                consumers_of[n].append((nm, sh))
        for nm in names:
            cons = consumers_of[nm]
            if cons and all(
                all(v == 0 for v in sh.values())
                and c != "__main__"
                and range_key(c) == range_key(nm)
                for c, sh in cons
            ):
                local.add(nm)

    # ---- rule 3: reuse windows ----------------------------------------------
    windows: dict = {}
    for nm in names:
        w = {}
        for lvl in aux_by_name[nm].levels:
            sh = shifts_seen[nm].get(lvl, [0])
            w[lvl] = max(sh) - min(sh) + 1
        windows[nm] = w

    return Plan(
        program=program,
        body=body,
        aux_order=aux_order,
        aux_exprs=exprs,
        ranges=ranges,
        windows=windows,
        refcounts=dict(refcounts),
        inlined=inlined,
        local=local,
        circles=circles,
        rounds=t.rounds,
    )


# ---------------------------------------------------------------------------
# Reporting helpers
# ---------------------------------------------------------------------------


def materialized_elements(plan: Plan, contracted: bool) -> int:
    """Total auxiliary elements stored (paper Fig 10 memory-volume proxy).
    Contracted mode keeps the innermost level full and clips every other
    level to its reuse window."""
    innermost = plan.program.depth
    total = 0
    for a in plan.aux_order:
        n = 1
        for lvl in a.levels:
            lo, hi = plan.ranges[a.name][lvl]
            ext = hi - lo + 1
            if contracted and lvl != innermost:
                ext = min(ext, plan.windows[a.name][lvl])
            n *= ext
        if contracted and a.name in plan.local:
            n = 1
        total += n
    return total
