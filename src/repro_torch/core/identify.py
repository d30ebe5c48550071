"""Own copy of ``repro/core/identify.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

The two-level identification scheme (paper Section 5).

Level 1 — reference pattern identifier (rpi, Algorithm 1): two array
references share an rpi iff they access the same infinite integer lattice,
i.e. equal basis matrices (same index list + coefficient list) and offset
difference inside the lattice (equal ``b mod a`` plus equal successive deltas
``b_k/a_k - b_j/a_j`` when one index appears in several subscripts).

Level 2 — expression redundancy identifier (eri, Algorithm 2): for a binary
expression ``x (+) y``, hash(rpi(x), op, rpi(y), exprDelta) where exprDelta is
the per-common-level difference of the operands' first-index offsets.  Equal
eri  =>  the expressions compute identical values at shifted iterations.

We use canonical hashable *tuples* instead of integer hashes: same linear-time
grouping property (dict buckets), zero collision risk, deterministic output.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

from .ir import Const, Expr, FuncName, Node, Ref, Sub

INF = None  # paper's "infinity" marker for absent loop levels


@dataclass(frozen=True)
class RefInfo:
    """Output of Algorithm 1 for one leaf."""

    index_list: tuple  # per array dim: level s_k, or 0 for constant dims
    index_coef: tuple  # per array dim: a_k (or b_k for constant dims)
    index_delta: tuple  # sorted ((level, (d0, d1, ...)), ...)
    first_offset: tuple  # sorted ((level, b/a of first occurrence), ...)

    def first_offset_map(self) -> dict:
        return dict(self.first_offset)

    def levels(self) -> tuple:
        return tuple(l for l, _ in self.first_offset)


def ref_info(leaf: Expr) -> RefInfo:
    """Algorithm 1.  Scalars/consts/function names have empty info."""
    if isinstance(leaf, (Const, FuncName)) or (isinstance(leaf, Ref) and not leaf.subs):
        return RefInfo((), (), (), ())
    assert isinstance(leaf, Ref)
    index_list, index_coef = [], []
    first: dict = {}
    delta: dict = {}
    for sub in leaf.subs:
        a, s, b = sub.a, sub.s, sub.b
        if a != 0 and s != 0:
            index_list.append(s)
            index_coef.append(a)
            off = Fraction(b, a)
            if s not in first:
                first[s] = off
                # b mod a must use the *integer* parts; b is integral for
                # source programs (Fractions appear only through shifts,
                # which preserve integrality of b for integral a*d).
                bi = int(b) if b.denominator == 1 else b
                delta.setdefault(s, []).append(
                    bi % a if isinstance(bi, int) else bi - (bi // a) * a
                )
            else:
                delta.setdefault(s, []).append(off - first[s])
        else:
            index_list.append(0)
            index_coef.append(b if a == 0 else a)
    return RefInfo(
        tuple(index_list),
        tuple(index_coef),
        tuple(sorted((k, tuple(v)) for k, v in delta.items())),
        tuple(sorted(first.items())),
    )


def rpi(leaf: Expr, info: Optional[RefInfo] = None) -> tuple:
    """Reference pattern identifier.  hash(name, indexList, indexCoef,
    indexDelta) — canonical tuple form."""
    if isinstance(leaf, Const):
        return ("const", leaf.val)
    if isinstance(leaf, FuncName):
        return ("fn", leaf.name)
    assert isinstance(leaf, Ref)
    info = info or ref_info(leaf)
    return ("ref", leaf.name, info.index_list, info.index_coef, info.index_delta)


def sort_key(leaf: Expr, info: Optional[RefInfo] = None):
    """Commutative-operand ordering (Section 5.2): sort by name, then the
    other rpi information, then first-index offsets as the final tie-break so
    that A[i]+A[i+1] and A[i+2]+A[i+1] land in a consistent order."""
    info = info or ref_info(leaf)
    return (rpi(leaf, info), info.first_offset)


def expr_delta(xi: RefInfo, yi: RefInfo) -> tuple:
    """Algorithm 2: per-level first-offset difference over common levels."""
    xm, ym = xi.first_offset_map(), yi.first_offset_map()
    return tuple(sorted((l, xm[l] - ym[l]) for l in set(xm) & set(ym)))


def eri(op: str, x: Expr, y: Expr, sx: int = 1, sy: int = 1,
        xi: Optional[RefInfo] = None, yi: Optional[RefInfo] = None) -> tuple:
    """Expression redundancy identifier for ``(sx*x) op (sy*y)``.

    Operands must already be in canonical (sorted) order for commutative ops.
    Sign/inversion flags (Section 7.1 subtraction/division rewriting) are part
    of the identity: y+z is redundant with -y-z via factored leading sign, so
    both canonicalize to flags (+,+)."""
    xi = xi or ref_info(x)
    yi = yi or ref_info(y)
    return (op, sx, rpi(x, xi), sy, rpi(y, yi), expr_delta(xi, yi))


def member_offsets(x: Expr, y: Expr, xi: Optional[RefInfo] = None,
                   yi: Optional[RefInfo] = None) -> dict:
    """Per-level iteration offset of a (canonically ordered) member: the
    first-index offset taken from whichever operand covers the level (the x
    operand wins on common levels; exprDelta equality across a group makes
    this consistent)."""
    xi = xi or ref_info(x)
    yi = yi or ref_info(y)
    out = dict(yi.first_offset)
    out.update(dict(xi.first_offset))
    return out


def integral_shift(d: Fraction) -> int:
    if isinstance(d, int):
        return d
    if d.denominator != 1:
        raise ValueError(f"non-integral shift {d}; rpi grouping should prevent this")
    return int(d)
