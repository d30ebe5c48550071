"""Own copy of ``repro/core/pairgraph.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Pair Graph construction and the MIS reduction (paper Sections 7.2-7.3).

Vertices are candidate binary subexpressions (pairs of leaf operand slots of
one n-ary operator node); an edge joins two pairs of the *same* node that
share an operand slot (they cannot be extracted simultaneously).  Colors are
eri values.  The objective over independent sets,

        argmax_{S in I_G} |S| - |eri(S)|                       (Eq. 1)

reduces to Maximum Independent Set on the augmented graph G-bar that adds one
auxiliary vertex per color adjacent to all vertices of that color (Thm 7.1).
We solve MIS exactly (branch & bound over connected components) up to a size
limit and fall back to a color-aware greedy heuristic beyond it; the
inner-dimension-first (IDF) strategy pre-filters candidates to
``exprDelta[level] == 0`` from the innermost level outward, accepting the
first level that yields a positive-objective solution (Section 7.3).
"""
from __future__ import annotations

from collections import defaultdict
from fractions import Fraction
from dataclasses import dataclass, field
from typing import Hashable, Iterable, Optional


@dataclass
class PairCand:
    """One candidate pair (vertex of the Pair Graph)."""

    vid: int
    node_id: Hashable  # owning n-ary node
    slots: tuple  # (slot_i, slot_j) within the node
    color: Hashable  # eri value
    delta: dict  # level -> Fraction (exprDelta of the pair; absent = paper's inf)
    payload: object = None  # detection bookkeeping (operands, offsets, ...)


def build_conflicts(cands: Iterable[PairCand]) -> dict:
    """Adjacency: same node sharing a slot."""
    adj = {c.vid: set() for c in cands}
    by_node = defaultdict(list)
    for c in cands:
        by_node[c.node_id].append(c)
    for group in by_node.values():
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                if set(a.slots) & set(b.slots):
                    adj[a.vid].add(b.vid)
                    adj[b.vid].add(a.vid)
    return adj


def _components(vids, adj):
    seen, comps = set(), []
    for v in vids:
        if v in seen:
            continue
        stack, comp = [v], []
        seen.add(v)
        while stack:
            u = stack.pop()
            comp.append(u)
            for w in adj[u]:
                if w in vids and w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(comp)
    return comps


_M64 = (1 << 64) - 1
_XXPRIME_1, _XXPRIME_2 = 11400714785074694791, 14029467366897019727
_XXPRIME_5 = 2870177450012600261


def _rotl(x: int, s: int) -> int:
    return ((x << s) | (x >> (64 - s))) & _M64


def _siphash13(data: bytes) -> int:
    """CPython's SipHash-1-3 string hash (``Python/pyhash.c``) with the
    all-zero key that ``PYTHONHASHSEED=0`` sets; unsigned 64-bit."""
    v = [0x736F6D6570736575, 0x646F72616E646F6D,
         0x6C7967656E657261, 0x7465646279746573]

    def sipround():
        v[0] = (v[0] + v[1]) & _M64
        v[2] = (v[2] + v[3]) & _M64
        v[1] = _rotl(v[1], 13) ^ v[0]
        v[3] = _rotl(v[3], 16) ^ v[2]
        v[0] = _rotl(v[0], 32)
        v[2] = (v[2] + v[1]) & _M64
        v[0] = (v[0] + v[3]) & _M64
        v[1] = _rotl(v[1], 17) ^ v[2]
        v[3] = _rotl(v[3], 21) ^ v[0]
        v[2] = _rotl(v[2], 32)

    n = len(data) - len(data) % 8
    for i in range(0, n, 8):
        m = int.from_bytes(data[i:i + 8], "little")
        v[3] ^= m
        sipround()
        v[0] ^= m
    b = ((len(data) & 0xFF) << 56) | int.from_bytes(data[n:], "little")
    v[3] ^= b
    sipround()
    v[0] ^= b
    v[2] ^= 0xFF
    for _ in range(3):
        sipround()
    return v[0] ^ v[1] ^ v[2] ^ v[3]


def _signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def seed0_hash(obj) -> int:
    """``hash(obj)`` as CPython 3.12 computes it under ``PYTHONHASHSEED=0``,
    in any process: strings by :func:`_siphash13`, tuples by the xxHash
    combine of ``Objects/tupleobject.c``; numbers and ``None`` hash the
    same under every seed.  Anything else hashes as its ``repr``."""
    if isinstance(obj, str):
        if not obj:
            return 0
        if obj.isascii():
            data = obj.encode()
        else:  # the string's internal 1-, 2- or 4-byte representation
            width = max((1, 2, 4)[(c > 0xFF) + (c > 0xFFFF)]
                        for c in map(ord, obj))
            data = b"".join(ord(c).to_bytes(width, "little") for c in obj)
        h = _signed(_siphash13(data))
        return -2 if h == -1 else h
    if isinstance(obj, tuple):
        acc = _XXPRIME_5
        for item in obj:
            lane = seed0_hash(item) & _M64
            acc = (acc + lane * _XXPRIME_2) & _M64
            acc = (_rotl(acc, 31) * _XXPRIME_1) & _M64
        acc = (acc + (len(obj) ^ (_XXPRIME_5 ^ 3527539))) & _M64
        return 1546275796 if acc == _M64 else _signed(acc)
    if obj is None or isinstance(obj, (bool, int, float, Fraction)):
        return hash(obj)
    return seed0_hash(repr(obj))


class ColorVertex(tuple):
    """A color vertex ``("color", eri_key)`` of G-bar whose hash is the one
    the plain tuple has under ``PYTHONHASHSEED=0`` (:func:`seed0_hash`).

    The branch and bound of :func:`mis_exact` breaks degree ties by set
    iteration order, and a plain tuple's slot in a set follows the string
    hash seed through ``eri_key``'s strings: one program could get another
    plan in another process.  With this hash every process sees the sets,
    and so the ties and the plan, that the reference sees under seed 0."""

    __slots__ = ()

    def __hash__(self) -> int:
        h = _HASHES.get(tuple(self))
        if h is None:
            h = _HASHES[tuple(self)] = seed0_hash(tuple(self))
        return h


#: seed-0 hashes of the color vertices seen so far (keyed by plain tuple)
_HASHES: dict = {}


def augment(vids, adj, colors) -> tuple:
    """Build G-bar: one auxiliary vertex per color, adjacent to all vertices
    of that color (Thm 7.1).  Aux vertices get ids ('color', k), as
    :class:`ColorVertex`."""
    bar_adj = {v: set(adj[v] & set(vids)) for v in vids}
    by_color = defaultdict(list)
    for v in vids:
        by_color[colors[v]].append(v)
    for k, vs in by_color.items():
        a = ColorVertex(("color", k))
        bar_adj[a] = set(vs)
        for v in vs:
            bar_adj[v].add(a)
    return bar_adj


def mis_exact(adj: dict, limit_nodes: int = 40) -> Optional[set]:
    """Exact MIS via branch & bound; None if the graph exceeds the limit.

    The branch vertex's ties go to the first in ``rem``'s iteration order,
    which :class:`ColorVertex` makes independent of ``PYTHONHASHSEED``."""
    nodes = list(adj)
    if len(nodes) > limit_nodes:
        return None
    best: set = set()

    def bb(rem: set, cur: set):
        nonlocal best
        if len(cur) + len(rem) <= len(best):
            return
        if not rem:
            if len(cur) > len(best):
                best = set(cur)
            return
        # pick max-degree vertex within rem
        v = max(rem, key=lambda u: len(adj[u] & rem))
        # branch 1: include v
        bb(rem - {v} - adj[v], cur | {v})
        # branch 2: exclude v
        bb(rem - {v}, cur)

    bb(set(nodes), set())
    return best


def mis_greedy(adj: dict) -> set:
    """Min-degree greedy MIS (good on sparse conflict graphs)."""
    rem = set(adj)
    out: set = set()
    while rem:
        v = min(rem, key=lambda u: (len(adj[u] & rem), str(u)))
        out.add(v)
        rem -= {v} | adj[v]
    return out


def objective(selected, colors) -> int:
    return len(selected) - len({colors[v] for v in selected})


def solve(cands: list, exact_limit: int = 40) -> set:
    """argmax |S| - |eri(S)| over independent sets; returns selected vids."""
    if not cands:
        return set()
    colors = {c.vid: c.color for c in cands}
    # prune colors with a single member program-wide: they can never add to
    # the objective but do add conflicts
    count = defaultdict(int)
    for c in cands:
        count[c.color] += 1
    cands = [c for c in cands if count[c.color] >= 2]
    if not cands:
        return set()
    adj = build_conflicts(cands)
    vids = {c.vid for c in cands}
    # decompose on the AUGMENTED graph: color vertices tie all same-color
    # pair vertices into one component, so the |eri(S)| penalty is counted
    # once per color exactly as in Thm 7.1
    bar = augment(vids, adj, colors)
    selected: set = set()
    for comp in _components(set(bar), bar):
        comp_set = set(comp)
        sub = {v: bar[v] & comp_set for v in comp}
        res = mis_exact(sub, exact_limit)
        if res is None:
            res = mis_greedy(sub)
        selected |= {v for v in res if not (isinstance(v, tuple) and v and v[0] == "color")}
    # drop colors that ended up singleton in the solution (objective-neutral)
    sel_count = defaultdict(int)
    for v in selected:
        sel_count[colors[v]] += 1
    return {v for v in selected if sel_count[colors[v]] >= 2}


def idf_solve(cands: list, levels_inner_first: list, exact_limit: int = 40) -> set:
    """Inner-dimension-first: try exprDelta[level]==0 subgraphs from the
    innermost level outward, accept the first positive-objective solution;
    fall back to the full graph (Section 7.3)."""
    colors = {c.vid: c.color for c in cands}
    for lvl in levels_inner_first:
        sub = [c for c in cands if c.delta.get(lvl, None) == 0]
        sel = solve(sub, exact_limit)
        if sel and objective(sel, colors) > 0:
            return sel
    return solve(cands, exact_limit)
