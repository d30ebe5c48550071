"""Own copy of ``repro/core/nary.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Redundancy elimination on n-ary trees (paper Section 7).

Pipeline per round: flatten (once, up-front) -> enumerate candidate pairs of
leaf operand slots per n-ary node -> Pair Graph -> IDF/MIS solve -> replace
selected pairs with auxiliary-array loads -> normalize -> repeat until no
positive-objective solution remains.  The final trees are re-binarized
(left-associative, signs folded into -//) for range analysis and code
generation, sharing the whole downstream pipeline with the binary path.

Flattening aggressiveness (Section 7.1):
  2  respect source parentheses: no flattening (pairs on existing binary
     nodes only — global MIS replaces the binary path's greedy take-all);
  3  merge same-operator chains into n-ary nodes (commutative/associative);
  4  additionally distribute multiplication by constants / loop-invariant
     scalars over sums (cautious distributive law).

``rewrite_sub`` turns ``x - y`` into ``(+x) + (-y)`` with sign flags so that
``y + z`` is identified with ``-y - z`` via a factored leading sign; the
first operand of each canonical pair is standardized to '+' (Section 7.1).
``rewrite_div`` does the same for division with inversion flags.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from fractions import Fraction

from . import identify as idf
from .detect import AuxDef, PaperCost, Transformed, aux_ref
from .ir import (COMMUTATIVE, Const, Expr, FuncName, Node, Program, Ref,
                 Stmt, count_ops, flop_weight, is_leaf)
from .pairgraph import PairCand, idf_solve, objective, solve

FIXED = {"-", "/", "call"}  # non-reassociable ops: the 2 kids are one pair


@dataclass(frozen=True)
class NNode:
    op: str  # '+', '*', or a FIXED op
    kids: tuple  # ((flag, expr), ...); flag -1 = negated ('+') / inverted ('*')


def _is_invariant(e) -> bool:
    """Constant or loop-invariant scalar (distribution guard, Section 7.1)."""
    return isinstance(e, Const) or (isinstance(e, Ref) and not e.subs)


def to_nary(e: Expr, level: int, fixed=frozenset({"call"})) -> Expr:
    """Convert a binary tree to n-ary form at the given aggressiveness."""
    return _conv(e, level, fixed)


def _distribute(n: NNode, level: int) -> Expr:
    """Level 4: distribute invariant multipliers over a single sum kid."""
    sums = [(i, k) for i, (f, k) in enumerate(n.kids)
            if isinstance(k, NNode) and k.op == "+"]
    others = [(f, k) for f, k in n.kids if not (isinstance(k, NNode) and k.op == "+")]
    if len(sums) != 1 or not others or not all(_is_invariant(k) for _, k in others):
        return n
    i_sum, s = sums[0]
    f_sum = n.kids[i_sum][0]
    terms = []
    for f2, term in s.kids:
        prod_kids = tuple(others) + ((1, term),)
        terms.append((f_sum * f2, NNode("*", prod_kids) if len(prod_kids) > 1 else term))
    out = NNode("+", tuple(terms))
    # re-flatten newly exposed chains
    return _renormalize(out)


def _renormalize(n: Expr) -> Expr:
    """Splice single-kid '+'/'*' chains and merge nested same-op nodes."""
    if not isinstance(n, NNode):
        return n
    kids = tuple((f, _renormalize(k)) for f, k in n.kids)
    if n.op in ("+", "*"):
        slots = []
        for f, k in kids:
            if isinstance(k, NNode) and k.op == n.op:
                slots.extend((f * f2, k2) for f2, k2 in k.kids)
            else:
                slots.append((f, k))
        if len(slots) == 1 and slots[0][0] == 1:
            return slots[0][1]
        return NNode(n.op, tuple(slots))
    return NNode(n.op, kids)


def to_binary(e) -> Expr:
    """Left-associative re-binarization with signs folded into - and /."""
    if is_leaf(e):
        return e
    if isinstance(e, Node):  # already binary (shouldn't happen mid-pipeline)
        return Node(e.op, tuple(to_binary(k) for k in e.kids))
    assert isinstance(e, NNode)
    if e.op in FIXED:
        assert len(e.kids) == 2, e
        return Node(e.op, (to_binary(e.kids[0][1]), to_binary(e.kids[1][1])))
    pos_first = sorted(range(len(e.kids)), key=lambda i: e.kids[i][0] != 1)
    kids = [e.kids[i] for i in pos_first]  # stable: positives first
    f0, k0 = kids[0]
    acc = to_binary(k0)
    if f0 == -1:
        acc = Node("neg" if e.op == "+" else "inv", (acc,))
    for f, k in kids[1:]:
        b = to_binary(k)
        if e.op == "+":
            acc = Node("+" if f == 1 else "-", (acc, b))
        else:
            acc = Node("*" if f == 1 else "/", (acc, b))
    return acc


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


def _canon_pair(op: str, sx: int, x: Expr, sy: int, y: Expr):
    """Canonical (x, y, sx, sy, factor): commutative sort + leading sign
    standardized to '+' (factor = -1 means the aux holds the negated/inverted
    value; Section 7.1)."""
    if op in COMMUTATIVE:
        if idf.sort_key(y) < idf.sort_key(x):
            x, y, sx, sy = y, x, sy, sx
    factor = 1
    if sx == -1:
        factor, sx, sy = -1, 1, -sy
    return x, y, sx, sy, factor


def _pair_info(op, sx, x, sy, y):
    x, y, sx, sy, factor = _canon_pair(op, sx, x, sy, y)
    xi, yi = idf.ref_info(x), idf.ref_info(y)
    key = idf.eri(op, x, y, sx, sy, xi, yi)
    offsets = idf.member_offsets(x, y, xi, yi)
    delta = dict(idf.expr_delta(xi, yi))
    return dict(x=x, y=y, sx=sx, sy=sy, factor=factor, key=key,
                offsets=offsets, delta=delta)


def collect_pairs(body, innermost=None):
    """All candidate pairs across all n-ary nodes of all statements."""
    cands: list = []
    vid = itertools.count()

    def visit(e, node_id):
        if is_leaf(e):
            return
        assert isinstance(e, NNode)
        for idx, (f, k) in enumerate(e.kids):
            visit(k, node_id + (idx,))
        leaf_slots = [(i, f, k) for i, (f, k) in enumerate(e.kids) if is_leaf(k)]
        if e.op in FIXED:
            if len(leaf_slots) == 2 and not isinstance(e.kids[0][1], NNode) \
               and not isinstance(e.kids[1][1], NNode):
                (i0, f0, k0), (i1, f1, k1) = leaf_slots
                info = _pair_info(e.op, f0, k0, f1, k1)
                key = info["key"]
                if innermost is not None:
                    outer = tuple(sorted((l, o) for l, o in info["offsets"].items()
                                         if l != innermost))
                    key = key + (("esr_outer", outer),)
                cands.append(PairCand(next(vid), node_id, (i0, i1), key,
                                      info["delta"], info))
            return
        for (i0, f0, k0), (i1, f1, k1) in itertools.combinations(leaf_slots, 2):
            info = _pair_info(e.op, f0, k0, f1, k1)
            key = info["key"]
            if innermost is not None:
                outer = tuple(sorted((l, o) for l, o in info["offsets"].items()
                                     if l != innermost))
                key = key + (("esr_outer", outer),)
            cands.append(PairCand(next(vid), node_id, (i0, i1), key,
                                  info["delta"], info))

    for si, st in enumerate(body):
        visit(st.rhs, (si,))
    return cands


# ---------------------------------------------------------------------------
# Replacement
# ---------------------------------------------------------------------------


def _apply(body, replacements):
    """replacements: node_id -> list of (slots_to_remove, new_slot)."""

    def rebuild(e, node_id):
        if is_leaf(e):
            return e
        assert isinstance(e, NNode)
        kids = tuple(
            (f, rebuild(k, node_id + (idx,))) for idx, (f, k) in enumerate(e.kids)
        )
        reps = replacements.get(node_id)
        if not reps:
            return NNode(e.op, kids)
        if e.op in FIXED:
            # the single pair was the whole operation
            assert len(reps) == 1
            _, new_slot = reps[0]
            f, k = new_slot
            assert f == 1
            return k
        drop = set()
        extra = []
        for slots, new_slot in reps:
            drop.update(slots)
            extra.append(new_slot)
        kids = tuple(k for i, k in enumerate(kids) if i not in drop) + tuple(extra)
        return NNode(e.op, kids)

    return tuple(
        Stmt(st.lhs, _renormalize(rebuild(st.rhs, (si,))))
        for si, st in enumerate(body)
    )


def detect_nary(
    program: Program,
    level: int = 3,
    cost_model=None,
    rewrite_sub: bool = True,
    rewrite_div: bool = False,
    max_rounds: int = 64,
    restrict_innermost: bool = False,
    mis_exact_limit: int = 40,
    use_idf: bool = True,
) -> Transformed:
    cost_model = cost_model or PaperCost()
    flatten_level = max(level, 2)
    # sub/div rewriting happens inside the n-ary conversion via sign flags;
    # without rewriting, '-' and '/' stay fixed-order single-pair nodes.
    fixed = {"call"}
    if not rewrite_sub:
        fixed.add("-")
    if not rewrite_div:
        fixed.add("/")

    def conv(e):
        return _conv(e, flatten_level, fixed)

    body = tuple(Stmt(st.lhs, _renormalize(conv(st.rhs))) for st in program.body)
    innermost_lv = program.depth if restrict_innermost else None
    levels_inner_first = list(range(program.depth, 0, -1))

    aux_defs: list = []
    log: list = []
    rnd = 0
    while rnd < max_rounds:
        cands = collect_pairs(body, innermost=innermost_lv)
        if not cands:
            break
        if use_idf:
            sel = idf_solve(cands, levels_inner_first, mis_exact_limit)
        else:
            sel = solve(cands, mis_exact_limit)
        colors = {c.vid: c.color for c in cands}
        if not sel or objective(sel, colors) <= 0:
            break
        by_key: dict = {}
        cand_by_vid = {c.vid: c for c in cands}
        for v in sorted(sel):
            c = cand_by_vid[v]
            by_key.setdefault(c.color, []).append(c)
        replacements: dict = {}
        k_idx = 0
        created = 0
        for key in sorted(by_key, key=lambda k: min(c.vid for c in by_key[k])):
            group = by_key[key]
            if len(group) < 2:
                continue
            opf = flop_weight(count_ops(_group_expr(group[0])))
            if not cost_model.approve(opf, len(group)):
                continue
            levels = tuple(sorted(set().union(
                *(set(c.payload["offsets"]) for c in group[:1]))))
            rep = min(group, key=lambda c: tuple(
                c.payload["offsets"].get(l, Fraction(0)) for l in levels))
            name = f"aa_{rnd}_{k_idx}"
            k_idx += 1
            aux = AuxDef(name, levels, _group_expr(rep), rnd, key, len(group))
            aux_defs.append(aux)
            created += 1
            for c in group:
                shift = {
                    l: idf.integral_shift(
                        c.payload["offsets"].get(l, Fraction(0))
                        - rep.payload["offsets"].get(l, Fraction(0))
                    )
                    for l in levels
                }
                new_slot = (c.payload["factor"], aux_ref(aux, shift))
                replacements.setdefault(c.node_id, []).append((c.slots, new_slot))
        if not created:
            break
        log.append({"round": rnd, "groups": created})
        body = _apply(body, replacements)
        rnd += 1

    final = tuple(Stmt(st.lhs, to_binary(st.rhs)) for st in body)
    return Transformed(program, aux_defs, final, rnd, log)


def _group_expr(c: PairCand) -> Expr:
    """Definition expression for the canonical pair: x (+|-|*|/) y, leading
    sign already factored out (the aux stores the '+'-standardized value)."""
    p = c.payload
    op = {
        ("+", 1): "+", ("+", -1): "-",
        ("*", 1): "*", ("*", -1): "/",
    }.get((_base_op(c), p["sy"]))
    if op is None:  # FIXED ops
        op = _base_op(c)
    if op == "call":
        return Node("call", (p["x"], p["y"]))
    return Node(op, (p["x"], p["y"]))


def _base_op(c: PairCand) -> str:
    return c.color[0]


def _conv(e: Expr, level: int, fixed: set) -> Expr:
    """to_nary with configurable fixed-op set."""
    if is_leaf(e):
        return e
    assert isinstance(e, Node)
    if e.op == "call":
        return NNode("call", ((1, e.kids[0]), (1, _conv(e.kids[1], level, fixed))))
    if e.op == "neg":
        return NNode("+", ((-1, _conv(e.kids[0], level, fixed)),))
    if e.op == "inv":
        return NNode("*", ((-1, _conv(e.kids[0], level, fixed)),))
    kids = [_conv(k, level, fixed) for k in e.kids]
    if e.op in fixed:
        return NNode(e.op, ((1, kids[0]), (1, kids[1])))
    if e.op in ("+", "-"):
        base, flags = "+", (1, 1 if e.op == "+" else -1)
    else:
        base, flags = "*", (1, 1 if e.op == "*" else -1)
    slots = []
    for flag, kid in zip(flags, kids):
        if level >= 3 and isinstance(kid, NNode) and kid.op == base:
            slots.extend((flag * f2, k2) for f2, k2 in kid.kids)
        else:
            slots.append((flag, kid))
    n = NNode(base, tuple(slots))
    if level >= 4 and base == "*":
        n = _distribute(n, level)
    return n
