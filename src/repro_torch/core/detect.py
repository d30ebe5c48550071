"""Own copy of ``repro/core/detect.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Binary-tree redundancy detection (paper Section 6.1).

Iteratively: compute rpi for leaves, eri for operator nodes whose kids are all
leaves, group program-wide by eri, replace every group (>= 2 occurrences, cost
model approving) with loads from a fresh auxiliary array, and continue on the
transformed trees until a fixed point.  Linear time per round: one bottom-up
traversal + dict grouping (no pairwise comparison).

Binary mode never reorders non-commutative ops and only exploits exact
commutativity of +/* (bitwise-safe in IEEE); floating-point results are
preserved exactly (tested, not just allclose).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Optional

from . import identify as idf
from .ir import (BINOPS, COMMUTATIVE, Const, Expr, FuncName, Node, Program,
                 Ref, Stmt, Sub, count_ops, flop_weight, is_leaf, map_expr)


# ---------------------------------------------------------------------------
# Cost models (paper: pure op-count profit; roofline: TPU-adapted, beyond-paper)
# ---------------------------------------------------------------------------


class PaperCost:
    """Paper Section 6.3 / 7.2: extracting n occurrences saves ~n-1 ops; any
    group of >= 2 is profitable."""

    def approve(self, op_flops: float, n: int, dtype_bytes: int = 4) -> bool:
        return n >= 2


class RooflineCost:
    """TPU-adapted profit (DESIGN.md section 2): materializing an aux array in
    HBM trades (n-1) op evaluations per element for extra memory traffic of
    roughly max(0, 3-n) element-moves (1 write + n reads replacing 2n operand
    reads).  Worth it iff flops saved >= bytes added x machine balance.  With
    ``vmem=True`` (the Pallas executor keeps aux tiles in VMEM scratch) the
    byte cost is ~0 and this degenerates to the paper model."""

    # The default balance is the H100's (data-sheet peak flop/s outside the
    # tensor cores over HBM bytes/s, ``launch/mesh.py``): 20 flop/B for
    # 4-byte elements, about 10 for 8-byte ones.  The reference's default is
    # its TPU's; pass ``balance_flops_per_byte`` for another machine's.
    # race() uses PaperCost, so this model is off the default path.
    def __init__(self, balance_flops_per_byte: Optional[float] = None,
                 vmem: bool = False):
        self.balance = balance_flops_per_byte
        self.vmem = vmem

    def balance_for(self, dtype_bytes: int) -> float:
        """flop/B at which an aux of ``dtype_bytes``-byte elements pays."""
        if self.balance is not None:
            return self.balance
        from ..launch.mesh import HBM_BW, PEAK_FLOPS

        return PEAK_FLOPS[8 if dtype_bytes >= 8 else 4] / HBM_BW

    def approve(self, op_flops: float, n: int, dtype_bytes: int = 4) -> bool:
        if n < 2:
            return False
        if self.vmem:
            return True
        extra_bytes = max(0.0, (3 - n)) * dtype_bytes
        return (n - 1) * op_flops >= extra_bytes * self.balance_for(dtype_bytes)


# ---------------------------------------------------------------------------


@dataclass
class AuxDef:
    """One auxiliary array ``name[i_l for l in levels] = expr`` (lhs implied
    at zero offset; `expr` keeps the representative's natural subscripts)."""

    name: str
    levels: tuple
    expr: Expr
    round: int
    eri_key: tuple
    n_members: int

    def lhs(self) -> Ref:
        return Ref(self.name, tuple(Sub(1, l, Fraction(0)) for l in self.levels))


@dataclass
class Transformed:
    program: Program
    aux: list
    body: tuple
    rounds: int
    log: list = field(default_factory=list)


@dataclass
class _Cand:
    """One eligible node occurrence."""

    node: Node
    op: str
    x: Expr
    y: Expr
    sx: int
    sy: int
    key: tuple
    offsets: dict  # level -> Fraction
    order: int  # first-appearance index for deterministic naming


def _canon_operands(node: Node):
    """Return (op, x, y) with commutative operands canonically sorted
    (Section 5.2).  Sorting for identification only; stored trees keep
    original order, which is bitwise-safe because IEEE +/* commute exactly."""
    op = node.op
    if op == "call":
        return op, node.kids[0], node.kids[1]
    x, y = node.kids
    if op in COMMUTATIVE:
        if idf.sort_key(y) < idf.sort_key(x):
            x, y = y, x
    return op, x, y


def eligible(node: Expr) -> bool:
    return (
        isinstance(node, Node)
        and node.op in (BINOPS | {"call"})
        and all(is_leaf(k) for k in node.kids)
    )


def _make_key(op, x, y, offsets, innermost=None):
    """eri key; in ESR mode (``innermost`` given) the group is additionally
    partitioned by the absolute offsets on non-innermost levels, so that only
    innermost-loop reuse distances remain within a group (ESR considers
    recomputation only across the innermost loop)."""
    key = idf.eri(op, x, y)
    if innermost is not None:
        outer = tuple(sorted((l, o) for l, o in offsets.items() if l != innermost))
        key = key + (("esr_outer", outer),)
    return key


def collect_candidates(body, counter_start: int = 0, innermost=None):
    """Scan statement trees for eligible nodes; returns eri-keyed groups."""
    groups: dict = {}
    order = counter_start

    def visit(e: Expr):
        nonlocal order
        if isinstance(e, Node):
            for k in e.kids:
                visit(k)
            if eligible(e):
                op, x, y = _canon_operands(e)
                xi, yi = idf.ref_info(x), idf.ref_info(y)
                offsets = idf.member_offsets(x, y, xi, yi)
                key = _make_key(op, x, y, offsets, innermost)
                cand = _Cand(e, op, x, y, 1, 1, key, offsets, order)
                groups.setdefault(key, []).append(cand)
                order += 1

    for st in body:
        visit(st.rhs)
    return groups


def group_levels(cands) -> tuple:
    lv = set()
    for c in cands[:1]:
        lv.update(c.offsets.keys())
    return tuple(sorted(lv))


def pick_representative(cands, levels):
    def keyf(c):
        return tuple(c.offsets.get(l, Fraction(0)) for l in levels)

    return min(cands, key=keyf)


def member_shift(c: _Cand, rep: _Cand, levels) -> dict:
    return {
        l: idf.integral_shift(c.offsets.get(l, Fraction(0)) - rep.offsets.get(l, Fraction(0)))
        for l in levels
    }


def aux_ref(aux: AuxDef, shift: dict) -> Ref:
    return Ref(aux.name, tuple(Sub(1, l, Fraction(shift.get(l, 0))) for l in aux.levels))


def detect_binary(
    program: Program,
    cost_model=None,
    max_rounds: int = 64,
    restrict_innermost: bool = False,
    aux_prefix: str = "aa",
) -> Transformed:
    cost_model = cost_model or PaperCost()
    body = program.body
    aux_defs: list = []
    log: list = []
    rnd = 0
    innermost = program.depth if restrict_innermost else None
    while rnd < max_rounds:
        groups = collect_candidates(body, innermost=innermost)
        selected = {}
        ordered = sorted(
            ((min(c.order for c in cs), k, cs) for k, cs in groups.items())
        )
        all_levels = set(range(1, program.depth + 1))
        k_idx = 0
        for _, key, cands in ordered:
            levels = group_levels(cands)
            # a singleton is extractable iff it is loop-invariant along some
            # level (its aux lacks that level): the paper's own profit model
            # (section 6.3) gives ori = vol(main) > aft = vol(aux) for cnt=1 —
            # this is what hoists e.g. the per-layer RoPE trig (integration.py)
            hoistable = len(cands) == 1 and set(levels) < all_levels
            if len(cands) < 2 and not hoistable:
                continue
            opf = flop_weight(count_ops(cands[0].node))
            if not cost_model.approve(opf, max(len(cands), 2)):
                continue
            rep = pick_representative(cands, levels)
            name = f"{aux_prefix}_{rnd}_{k_idx}"
            k_idx += 1
            aux = AuxDef(name, levels, rep.node, rnd, key, len(cands))
            aux_defs.append(aux)
            selected[key] = (aux, rep)
        if not selected:
            break
        log.append({"round": rnd, "groups": len(selected)})

        def rewrite(e: Expr) -> Expr:
            if eligible(e):
                op, x, y = _canon_operands(e)
                key = _make_key(op, x, y, idf.member_offsets(x, y), innermost)
                if key in selected:
                    aux, rep = selected[key]
                    offs = idf.member_offsets(x, y)
                    shift = {
                        l: idf.integral_shift(
                            offs.get(l, Fraction(0)) - rep.offsets.get(l, Fraction(0))
                        )
                        for l in aux.levels
                    }
                    return aux_ref(aux, shift)
            return e

        body = tuple(Stmt(st.lhs, map_expr(st.rhs, rewrite)) for st in body)
        rnd += 1
    return Transformed(program, aux_defs, body, rnd, log)
