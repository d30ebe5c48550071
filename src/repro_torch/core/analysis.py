"""Own copy of ``repro/core/analysis.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Redundancy/profit analysis (paper Section 6.3) and the static operation
table (paper Table 1 columns).

  ori = prod_t r(i_t) * sum_k ops(aa_k) * cnt(aa_k)
        — ops() of the *recursively expanded* representative expression,
          cnt() counted over the transformed expression trees;
  aft = sum_k prod_t r(i_t, aa_k)
        — each aux's precompute expression is one binary op per element;
  profit = ori - aft.

The per-iteration table weights each emitted statement by its range volume
relative to the main loop volume, which reduces to the paper's counting when
aux ranges match the main ranges (all paper kernels) and correctly discounts
hoisted loop-invariant computation (e.g. the RoPE layer-loop aux).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from .depgraph import Plan
from .ir import Program, count_ops, expr_refs, substitute


def _vol(ranges: dict) -> int:
    v = 1
    for lo, hi in ranges.values():
        v *= hi - lo + 1
    return v


@dataclass
class ProfitReport:
    ori: float
    aft: float

    @property
    def profit(self) -> float:
        return self.ori - self.aft


def profit(plan: Plan) -> ProfitReport:
    main_vol = _vol(plan.program.ranges())
    aux_names = {a.name for a in plan.aux_order}
    table = {a.name: plan.aux_exprs[a.name] for a in plan.aux_order}

    cnt: Counter = Counter()
    for st in plan.body:
        for r in expr_refs(st.rhs):
            if r.name in aux_names:
                cnt[r.name] += 1

    ori = 0.0
    for a in plan.aux_order:
        expanded = substitute(plan.aux_exprs[a.name], table)
        ops = sum(count_ops(expanded).values())
        ori += main_vol * ops * cnt[a.name]

    aft = 0.0
    for a in plan.aux_order:
        aft += _vol(plan.ranges[a.name]) * max(
            1, sum(count_ops(plan.aux_exprs[a.name]).values())
        )
    return ProfitReport(ori, aft)


CATEGORIES = ("add", "sub", "mul", "div", "sincos")


def _bucket(c: Counter) -> Counter:
    out: Counter = Counter()
    for k, v in c.items():
        if k in ("sin", "cos"):
            out["sincos"] += v
        elif k in ("add", "sub", "mul", "div"):
            out[k] += v
        else:
            out["call"] += v
    return out


def op_table(program: Program, plan: Plan = None, asymptotic: bool = True) -> dict:
    """Static per-innermost-iteration op counts.

    Returns {'add': x, 'sub': ..., 'weighted_total': float}.  For a plan, aux
    statements are weighted by their range volume over the main loop volume.
    With ``asymptotic`` (the paper's convention) levels shared with the main
    nest weigh 1 (halo boundaries ignored); levels the aux *lacks* weigh
    1/extent — this discounts hoisted loop-invariant computation while giving
    integer counts for same-rank auxs (paper Table 1)."""
    main_vol = _vol(program.ranges())
    full = program.ranges()
    counts: Counter = Counter()
    total = 0.0
    if plan is None:
        for st in program.body:
            c = _bucket(count_ops(st.rhs))
            counts.update(c)
            total += sum(count_ops(st.rhs).values())
    else:
        for st in plan.body:
            c = count_ops(st.rhs)
            counts.update(_bucket(c))
            total += sum(c.values())
        for a in plan.aux_order:
            if asymptotic:
                w = 1.0
                for lvl, (lo, hi) in full.items():
                    if lvl not in a.levels:
                        w /= hi - lo + 1
            else:
                w = _vol(plan.ranges[a.name]) / main_vol
            c = count_ops(plan.aux_exprs[a.name])
            for k, v in _bucket(c).items():
                counts[k] += v * w
            total += sum(c.values()) * w
    out = {k: counts.get(k, 0) for k in CATEGORIES}
    out["call"] = counts.get("call", 0)
    out["weighted_total"] = total
    return out


def reduced_ops_fraction(program: Program, plan: Plan) -> float:
    """Paper Table 1 'Reduced Ops': fraction of run-time arithmetic removed."""
    base = op_table(program)["weighted_total"]
    after = op_table(program, plan)["weighted_total"]
    return 1.0 - after / base if base else 0.0
