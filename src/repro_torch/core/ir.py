"""Own copy of ``repro/core/ir.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Expression-tree IR for RACE (Redundant Array Computation Elimination).

The paper's scope (Section 4.1): perfectly nested loops, no internal control
flow, array references of the affine form ``A[a1*i_{s1}+b1]...[an*i_{sn}+bn]``
where ``s_k`` is a loop level (1 = outermost .. m = innermost), ``a_k``/``b_k``
integer constants.  Scalars are zero-dimensional references; function calls
``f(x)`` are binary nodes ``f (.) x`` whose left operand is the function name
treated as a scalar (Section 4.1).

Everything here is immutable; transformation passes rebuild trees.
"""
from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Iterable, Mapping, Optional, Sequence, Union

# ---------------------------------------------------------------------------
# Leaves and nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sub:
    """One subscript ``a * i_s + b``.  ``s == 0`` marks a constant dimension
    (then ``a == 0`` and the constant lives in ``b``), per Algorithm 1."""

    a: int
    s: int
    b: Fraction

    def __post_init__(self):
        object.__setattr__(self, "b", Fraction(self.b))
        if self.s == 0 and self.a != 0:
            raise ValueError("constant dimension must have a == 0")

    def shifted(self, d: Fraction) -> "Sub":
        # shifting the *iteration* by d moves the accessed index by a*d
        return Sub(self.a, self.s, self.b + self.a * Fraction(d))


@dataclass(frozen=True)
class Ref:
    """Array reference.  ``subs == ()`` is a scalar variable."""

    name: str
    subs: tuple = ()

    @property
    def is_scalar(self) -> bool:
        return not self.subs

    def levels(self) -> tuple:
        return tuple(sorted({s.s for s in self.subs if s.s != 0}))


@dataclass(frozen=True)
class Const:
    val: float


@dataclass(frozen=True)
class FuncName:
    """Function name treated as a scalar operand of a 'call' node."""

    name: str


@dataclass(frozen=True)
class Node:
    """Operator node.  ops: ``+ - * / call neg inv``.

    'call' has kids (FuncName, arg).  'neg'/'inv' are unary and only appear
    after reassociation rewrites (Section 7.1); they never appear in
    binary-faithful mode.
    """

    op: str
    kids: tuple

    def __post_init__(self):
        arity = {"neg": 1, "inv": 1}.get(self.op, 2)
        if len(self.kids) != arity:
            raise ValueError(f"op {self.op} wants {arity} kids, got {len(self.kids)}")


Expr = Union[Ref, Const, FuncName, Node]

COMMUTATIVE = {"+", "*"}
BINOPS = {"+", "-", "*", "/"}


def is_leaf(e: Expr) -> bool:
    return isinstance(e, (Ref, Const, FuncName))


# ---------------------------------------------------------------------------
# Loop nests / statements / programs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SourceLoc:
    """Where a construct came from in user source (frontend capture).

    Excluded from equality/hashing everywhere it is attached: two programs
    are the same program regardless of which file they were written in.
    """

    file: str
    line: int
    col: int = 0

    def __str__(self) -> str:
        return f"{self.file}:{self.line}:{self.col}"


@dataclass(frozen=True)
class Loop:
    """One loop ``for var in [lo, hi]`` (inclusive), unit stride."""

    level: int
    var: str
    lo: int
    hi: int

    @property
    def extent(self) -> int:
        return self.hi - self.lo + 1


@dataclass(frozen=True)
class Stmt:
    """``lhs = rhs`` inside the nest.  lhs subscripts must be unit-coefficient
    distinct-level (writes sweep a box)."""

    lhs: Ref
    rhs: Expr
    loc: Optional[SourceLoc] = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class Program:
    """A perfectly nested loop (outermost first) over a straight-line body."""

    loops: tuple
    body: tuple
    loc: Optional[SourceLoc] = field(default=None, compare=False, repr=False)

    @property
    def depth(self) -> int:
        return len(self.loops)

    def loop(self, level: int) -> Loop:
        return self.loops[level - 1]

    def ranges(self) -> dict:
        return {l.level: (l.lo, l.hi) for l in self.loops}

    def var(self, level: int) -> str:
        return self.loops[level - 1].var

    def volume(self) -> int:
        v = 1
        for l in self.loops:
            v *= l.extent
        return v


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------


def walk(e: Expr):
    """Post-order traversal."""
    if isinstance(e, Node):
        for k in e.kids:
            yield from walk(k)
    yield e


def map_expr(e: Expr, fn) -> Expr:
    """Bottom-up rebuild: fn applied to every node after kids are rebuilt."""
    if isinstance(e, Node):
        e = Node(e.op, tuple(map_expr(k, fn) for k in e.kids))
    return fn(e)


def expr_refs(e: Expr) -> list:
    return [x for x in walk(e) if isinstance(x, Ref)]


def expr_levels(e: Expr) -> tuple:
    lv = set()
    for r in expr_refs(e):
        lv.update(r.levels())
    return tuple(sorted(lv))


def shift_expr(e: Expr, shifts: Mapping[int, Fraction]) -> Expr:
    """Evaluate-at-shifted-iteration: i_l -> i_l + shifts[l] in every ref."""

    def fn(x):
        if isinstance(x, Ref) and x.subs:
            return Ref(
                x.name,
                tuple(s.shifted(shifts.get(s.s, 0)) if s.s else s for s in x.subs),
            )
        return x

    return map_expr(e, fn)


def substitute(e: Expr, table: Mapping[str, Expr]) -> Expr:
    """Replace aux refs by (shifted) definition bodies.  table maps aux name
    to its definition expr written at zero shift; a ref aa[i+2, j] splices the
    body shifted by (+2, 0)."""

    def fn(x):
        if isinstance(x, Ref) and x.name in table:
            shifts = {s.s: s.b for s in x.subs if s.s != 0}
            return substitute(shift_expr(table[x.name], shifts), table)
        return x

    return map_expr(e, fn)


def count_ops(e: Expr) -> Counter:
    """Static op counts by category (paper Table 1 columns)."""
    c: Counter = Counter()
    for x in walk(e):
        if isinstance(x, Node):
            if x.op == "call":
                c[x.kids[0].name] += 1
            elif x.op == "+":
                c["add"] += 1
            elif x.op == "-":
                c["sub"] += 1
            elif x.op == "neg":
                c["sub"] += 1
            elif x.op == "*":
                c["mul"] += 1
            elif x.op in ("/",):
                c["div"] += 1
            elif x.op == "inv":
                c["div"] += 1
    return c


# weights used by the roofline cost model (approximate flop cost per op)
OP_FLOPS = {"add": 1, "sub": 1, "mul": 1, "div": 4, "sin": 20, "cos": 20,
            "exp": 15, "log": 20, "sqrt": 4, "tanh": 25, "abs": 1}


def flop_weight(counts: Counter) -> float:
    return float(sum(OP_FLOPS.get(k, 10) * v for k, v in counts.items()))


# ---------------------------------------------------------------------------
# Builder DSL
# ---------------------------------------------------------------------------


class IdxExpr:
    """Affine index expression ``a*i + b`` for one loop variable."""

    def __init__(self, level: int, name: str, a: int = 1, b=0):
        self.level, self.name, self.a, self.b = level, name, a, Fraction(b)

    def __add__(self, k):
        return IdxExpr(self.level, self.name, self.a, self.b + k)

    __radd__ = __add__

    def __sub__(self, k):
        return IdxExpr(self.level, self.name, self.a, self.b - k)

    def __mul__(self, k):
        return IdxExpr(self.level, self.name, self.a * k, self.b * k)

    __rmul__ = __mul__

    def __neg__(self):
        return IdxExpr(self.level, self.name, -self.a, -self.b)

    def to_sub(self) -> Sub:
        return Sub(self.a, self.level, self.b)


class Array:
    def __init__(self, name: str):
        self.name = name

    def __getitem__(self, idx) -> Ref:
        if not isinstance(idx, tuple):
            idx = (idx,)
        subs = []
        for x in idx:
            if isinstance(x, IdxExpr):
                subs.append(x.to_sub())
            elif isinstance(x, (int, Fraction)):
                subs.append(Sub(0, 0, Fraction(x)))
            else:
                raise TypeError(f"bad subscript {x!r}")
        return Ref(self.name, tuple(subs))


class Scalar:
    def __new__(cls, name: str) -> Ref:
        return Ref(name, ())


def arr(name: str) -> Array:
    return Array(name)


def _wrap(x) -> Expr:
    if isinstance(x, (int, float)):
        return Const(float(x))
    if isinstance(x, Fraction):
        return Const(float(x))
    return x


class _OpMixin:
    pass


def _bin(op: str, a, b) -> Node:
    return Node(op, (_wrap(a), _wrap(b)))


# free-function expression builders (used by benchmark kernels and tests)
def add(a, b):
    return _bin("+", a, b)


def sub_(a, b):
    return _bin("-", a, b)


def mul(a, b):
    return _bin("*", a, b)


def div(a, b):
    return _bin("/", a, b)


def call(fname: str, x) -> Node:
    return Node("call", (FuncName(fname), _wrap(x)))


def sin(x):
    return call("sin", x)


def cos(x):
    return call("cos", x)


def exp(x):
    return call("exp", x)


def sqrt(x):
    return call("sqrt", x)


def tanh(x):
    return call("tanh", x)


# allow operator syntax on IR dataclasses
def _install_operators():
    def addop(self, o):
        return _bin("+", self, o)

    def raddop(self, o):
        return _bin("+", o, self)

    def subop(self, o):
        return _bin("-", self, o)

    def rsubop(self, o):
        return _bin("-", o, self)

    def mulop(self, o):
        return _bin("*", self, o)

    def rmulop(self, o):
        return _bin("*", o, self)

    def divop(self, o):
        return _bin("/", self, o)

    def rdivop(self, o):
        return _bin("/", o, self)

    def negop(self):
        return Node("neg", (self,))

    for cls in (Ref, Const, FuncName, Node):
        cls.__add__ = addop
        cls.__radd__ = raddop
        cls.__sub__ = subop
        cls.__rsub__ = rsubop
        cls.__mul__ = mulop
        cls.__rmul__ = rmulop
        cls.__truediv__ = divop
        cls.__rtruediv__ = rdivop
        cls.__neg__ = negop


_install_operators()


def loopnest(*loops) -> tuple:
    """``loopnest(('j', 1, ny), ('i', 1, nx))`` -> (Loop tuple, IdxExprs)."""
    ls, idxs = [], []
    for lvl, (name, lo, hi) in enumerate(loops, start=1):
        ls.append(Loop(lvl, name, lo, hi))
        idxs.append(IdxExpr(lvl, name))
    return tuple(ls), tuple(idxs)


def program(loops, body: Sequence[tuple]) -> Program:
    """body: sequence of (lhs Ref, rhs Expr)."""
    return Program(tuple(loops), tuple(Stmt(l, _wrap(r)) for l, r in body))


# ---------------------------------------------------------------------------
# Source printing (C-like; for docs, debugging, and the paper-figure demos)
# ---------------------------------------------------------------------------


def _fmt_frac(f: Fraction) -> str:
    return str(f.numerator) if f.denominator == 1 else f"{f.numerator}/{f.denominator}"


def fmt_sub(s: Sub, varname: str) -> str:
    if s.s == 0:
        return _fmt_frac(s.b)
    t = varname if s.a == 1 else (f"-{varname}" if s.a == -1 else f"{s.a}*{varname}")
    if s.b == 0:
        return t
    sign = "+" if s.b > 0 else "-"
    return f"{t}{sign}{_fmt_frac(abs(s.b))}"


def fmt_ref(r: Ref, varnames: Mapping[int, str]) -> str:
    if not r.subs:
        return r.name
    inner = ",".join(fmt_sub(s, varnames.get(s.s, f"i{s.s}")) for s in r.subs)
    return f"{r.name}[{inner}]"


_PREC = {"+": 1, "-": 1, "*": 2, "/": 2, "neg": 3, "inv": 3, "call": 4}


def fmt_expr(e: Expr, varnames: Mapping[int, str], prec: int = 0) -> str:
    if isinstance(e, Ref):
        return fmt_ref(e, varnames)
    if isinstance(e, Const):
        v = e.val
        return str(int(v)) if float(v).is_integer() else repr(v)
    if isinstance(e, FuncName):
        return e.name
    if e.op == "call":
        return f"{e.kids[0].name}({fmt_expr(e.kids[1], varnames)})"
    if e.op == "neg":
        s = f"-{fmt_expr(e.kids[0], varnames, _PREC['neg'])}"
        return f"({s})" if prec > _PREC["neg"] else s
    if e.op == "inv":
        return f"(1/{fmt_expr(e.kids[0], varnames, _PREC['inv'])})"
    p = _PREC[e.op]
    s = f"{fmt_expr(e.kids[0], varnames, p)} {e.op} {fmt_expr(e.kids[1], varnames, p + 1)}"
    return f"({s})" if prec > p else s
