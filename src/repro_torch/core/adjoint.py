"""Adjoint-stencil differentiation for RACE programs (reverse mode), on
PyTorch.

Port of ``repro/core/adjoint.py``.  The gradient of a stencil is itself a
stencil: transposing ``out[i] = sum_r c_r * u[i + d_r]`` over the iteration
box gives ``gu[j] = sum_r c_r(j - d_r) * gout[j - d_r]``.  This module builds
that transposed program symbolically on the IR and pushes it back through
the port's RACE pipeline (detection, contraction, the plan-keyed executor
cache and the backend layer), so the backward pass gets the same auxiliary
array elimination as the forward and, on the card, runs through the same
Hopper stencil kernel.

  * :func:`derivative` / :func:`simplify` — symbolic d(rhs)/d(ref) on the IR
    (the reference's rules, copied; they use only the IR);
  * :func:`adjoint_build` — memoized, one adjoint :class:`~.ir.Program` per
    differentiable input, or a refusal with one of the nine codes below; the
    backward then falls back to autograd through the *baseline* evaluator;
  * :class:`ScalarGroup` — two or more wanted scalar specs as one adjoint
    program (:meth:`AdjointBuild.scalar_group`), run as one summed K1
    launch where :func:`adjoint_runs` admits it;
  * :func:`backward` — the runtime VJP: pad cotangents (zeros; K1 reads
    them unpadded, its guards supplying the zeros) and coefficient arrays
    (ones: the zero cotangent already annihilates those terms, and ones
    keep divisions finite), run each adjoint plan through
    :func:`~.executor.compile_plan` under the default backend, sum the
    broadcast axes, and embed the result into input-shaped zeros.
    :class:`~.executor.CompiledRace` installs it as a
    ``torch.autograd.Function``, so ``RaceResult.run`` and ``run_batch``
    differentiate with no change to their API.  With ``batched`` every env
    entry and cotangent carries a leading batch axis: pads and sums act on
    the per-example dimensions only, and the adjoint plans run through
    ``run_batch``.  Every step is a differentiable torch op or an executor
    call, so under ``create_graph`` the backward differentiates again (the
    reference's backward is plain JAX).

Unlike the reference, an integer or unread input gets ``None`` (torch has no
``float0``), and only the inputs autograd asks for are computed.  A wanted
input the program reads gets a tensor on every path: zeros where its terms
all cancel (:func:`complete_gradients`).

Telemetry (``RACE_OBS``) as the reference's: an ``adjoint_build`` span,
``race_adjoint_builds_total{outcome}`` and the ``adjoint_refusal`` event
around each (memoized) build; ``race_adjoint_backward_total{mode}`` and an
``adjoint_backward`` span in :func:`backward`.  The reference's backward
runs inside ``jax.jit``, so its counter and span fire once per trace; this
backward is eager, so they fire once per backward call.  The port's own
``race_adjoint_pads_total{how, kind}`` counts each padded feed of a
backward (:func:`assemble_adjoint_env`).

Env knobs: ``RACE_ADJOINT`` — ``"stencil"`` (default) or ``"autodiff"``
(force the fallback); ``RACE_ADJOINT_REASSOCIATE`` — reassociation level of
the adjoint programs (default 3).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Iterable, Mapping, Optional

import torch
import torch.nn.functional as F

from .. import obs as _obs
from . import ir as _ir
from .ir import (Const, Expr, FuncName, Loop, Node, Program, Ref, Stmt, Sub,
                 expr_refs, map_expr)

ENV_ADJOINT = "RACE_ADJOINT"
ENV_ADJOINT_REASSOCIATE = "RACE_ADJOINT_REASSOCIATE"

#: structured reasons an adjoint build refuses (mirrors the backend probe's
#: vocabulary: a fallback always carries a machine-checkable cause)
STRIDED_READ = "STRIDED_READ"          # |a| >= 2 subscript coefficient
REPEATED_LEVEL = "REPEATED_LEVEL"      # same loop level twice in one ref
CONST_DIM = "CONST_DIM"                # constant dimension in an input read
MIXED_LAYOUT = "MIXED_LAYOUT"          # inconsistent dim->level map or sign
READ_AFTER_WRITE = "READ_AFTER_WRITE"  # reads another statement's output
NONDIFF_OP = "NONDIFF_OP"              # no derivative rule (e.g. abs)
NON_INTEGRAL = "NON_INTEGRAL"          # fractional subscript offset
LHS_FORM = "LHS_FORM"                  # lhs not a unit box / reserved name
NEGATIVE_INDEX = "NEGATIVE_INDEX"      # forward would read below index 0


class AdjointUnsupported(Exception):
    """Program outside the transposable scope; ``reason`` is structured."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}" if detail else reason)


def adjoint_mode() -> str:
    """``$RACE_ADJOINT``: "stencil" (default) or "autodiff"."""
    mode = os.environ.get(ENV_ADJOINT, "").strip() or "stencil"
    if mode not in ("stencil", "autodiff"):
        raise ValueError(
            f"{ENV_ADJOINT}={mode!r} is not 'stencil' or 'autodiff'")
    return mode


def adjoint_reassociate() -> int:
    raw = os.environ.get(ENV_ADJOINT_REASSOCIATE, "").strip()
    if not raw:
        return 3
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_ADJOINT_REASSOCIATE}={raw!r} is not an integer") from None


# ---------------------------------------------------------------------------
# symbolic differentiation on the IR
# ---------------------------------------------------------------------------

_ZERO = Const(0.0)
_ONE = Const(1.0)


def _is_const(e, v: Optional[float] = None) -> bool:
    return isinstance(e, Const) and (v is None or float(e.val) == v)


def simplify(e: Expr) -> Expr:
    """Constant folding plus 0/1 identities — keeps the adjoint programs the
    detector sees free of degenerate terms the derivation introduced."""
    if not isinstance(e, Node):
        return e
    kids = tuple(simplify(k) for k in e.kids)
    op = e.op
    if op == "call":
        return Node(op, kids)
    if op == "neg":
        (a,) = kids
        if _is_const(a):
            return Const(-float(a.val))
        if isinstance(a, Node) and a.op == "neg":
            return a.kids[0]
        return Node("neg", (a,))
    if op == "inv":
        (a,) = kids
        if _is_const(a) and float(a.val) != 0.0:
            return Const(1.0 / float(a.val))
        return Node("inv", (a,))
    a, b = kids
    if op == "+":
        if _is_const(a, 0.0):
            return b
        if _is_const(b, 0.0):
            return a
        if _is_const(a) and _is_const(b):
            return Const(float(a.val) + float(b.val))
    elif op == "-":
        if _is_const(b, 0.0):
            return a
        if _is_const(a, 0.0):
            return simplify(Node("neg", (b,)))
        if _is_const(a) and _is_const(b):
            return Const(float(a.val) - float(b.val))
    elif op == "*":
        if _is_const(a, 0.0) or _is_const(b, 0.0):
            return _ZERO
        if _is_const(a, 1.0):
            return b
        if _is_const(b, 1.0):
            return a
        if _is_const(a) and _is_const(b):
            return Const(float(a.val) * float(b.val))
    elif op == "/":
        if _is_const(a, 0.0):
            return _ZERO
        if _is_const(b, 1.0):
            return a
        if _is_const(a) and _is_const(b) and float(b.val) != 0.0:
            return Const(float(a.val) / float(b.val))
    return Node(op, (a, b))


def _d(e: Expr, wrt: Ref) -> Expr:
    if isinstance(e, Ref):
        return _ONE if e == wrt else _ZERO
    if isinstance(e, (Const, FuncName)):
        return _ZERO
    op = e.op
    if op == "call":
        fname = e.kids[0].name
        x = e.kids[1]
        dx = simplify(_d(x, wrt))
        if _is_const(dx, 0.0):
            return _ZERO
        if fname == "sin":
            return Node("call", (FuncName("cos"), x)) * dx
        if fname == "cos":
            return Node("neg", (Node("call", (FuncName("sin"), x)) * dx,))
        if fname == "exp":
            return e * dx
        if fname == "log":
            return dx / x
        if fname == "sqrt":
            return dx / (Const(2.0) * e)
        if fname == "tanh":
            return (Const(1.0) - e * e) * dx
        raise AdjointUnsupported(NONDIFF_OP,
                                 f"call {fname!r} has no derivative rule")
    if op == "neg":
        return Node("neg", (_d(e.kids[0], wrt),))
    if op == "inv":
        a = e.kids[0]
        da = simplify(_d(a, wrt))
        if _is_const(da, 0.0):
            return _ZERO
        return Node("neg", (da / (a * a),))
    a, b = e.kids
    da, db = simplify(_d(a, wrt)), simplify(_d(b, wrt))
    if op == "+":
        return da + db
    if op == "-":
        return da - db
    if op == "*":
        return da * b + a * db
    if op == "/":
        return da / b - (a * db) / (b * b)
    raise AdjointUnsupported(NONDIFF_OP, f"op {op!r}")


def derivative(e: Expr, wrt: Ref) -> Expr:
    """Symbolic ∂e/∂wrt, where ``wrt`` is a specific reference (all
    structurally equal occurrences count — that multiplicity is exactly the
    reuse RACE detects)."""
    return simplify(_d(e, wrt))


# ---------------------------------------------------------------------------
# adjoint program construction
# ---------------------------------------------------------------------------

COTANGENT_PREFIX = "_g_"  # cotangent canvas of one forward output
ADJOINT_PREFIX = "_adj_"  # gradient accumulator of one forward input


def _as_int(f, what: str = "subscript offset") -> int:
    f = Fraction(f)
    if f.denominator != 1:
        raise AdjointUnsupported(NON_INTEGRAL, f"{what} {f}")
    return int(f)


def _sub_range(a: int, b, lo: int, hi: int) -> tuple:
    """Index interval touched by ``a*i + b`` over ``i in [lo, hi]``."""
    x, y = a * lo + _as_int(b), a * hi + _as_int(b)
    return (min(x, y), max(x, y))


def _ref_sort_key(r: Ref) -> tuple:
    return (r.name, tuple((s.a, s.s, str(s.b)) for s in r.subs))


@dataclass
class InputSpec:
    """One input's adjoint: a standalone stencil program plus the recipe for
    feeding it (padded cotangents / coefficient arrays) and for shaping its
    output back into the input's geometry."""

    input: str        # forward env entry being differentiated
    program: Program  # the transposed stencil program
    gu: str           # its single output (gradient over the access hull)
    #: per input dim: (lo, hi) — where the hull lands in the input's index
    #: space (gradient is zero outside: the forward never read there)
    embed: tuple
    #: trailing gu axes to sum away (forward levels the input does not
    #: carry — scalars and partial-rank arrays broadcast over them)
    sum_axes: tuple
    #: adjoint env assembly: (kind, forward name, adjoint name, pads) where
    #: kind "cotangent" pads are static (lo, hi) zero-pads, kind "array"
    #: pads are (lo, max_shifted_index) with the high pad resolved against
    #: the runtime shape (ones-fill), kind "scalar" passes through
    feeds: tuple
    _race: dict = field(default_factory=dict, repr=False)

    @property
    def scalar(self) -> bool:
        """A scalar's spec: its ``sum_axes`` cover every level, so only the
        sum of ``gu`` is wanted (:meth:`CompiledRace.run_sum`)."""
        return len(self.sum_axes) == len(self.program.loops)

    @property
    def members(self) -> tuple:
        """The specs whose gradients one run of this program gives."""
        return (self,)

    def result(self, reassociate: Optional[int] = None):
        """RACE result for the adjoint program (memoized per level)."""
        return _memo_race(self, reassociate)


def _memo_race(unit, reassociate: Optional[int]):
    lvl = adjoint_reassociate() if reassociate is None else reassociate
    res = unit._race.get(lvl)
    if res is None:
        from .race import race

        res = unit._race[lvl] = race(unit.program, reassociate=lvl)
    return res


@dataclass
class ScalarGroup:
    """Two or more scalar specs of one program run as one adjoint program.

    Every scalar spec sweeps the forward's whole box, so the members share
    their loops; the group's program has one statement per member, its
    ``gu`` from its right-hand side, fed by one pad pass over them all
    (:func:`group_program`).  On K1 that is one summed launch: it reads the
    cotangents and the operands once, RACE shares aux across the members'
    statements, and each member gets its own partials.  Each member's own
    program stays as it is; the merging happens only at the run."""

    members: tuple    # the member InputSpecs, in the build's order
    program: Program  # one statement per member, over their loops
    feeds: tuple      # the recipe of :attr:`InputSpec.feeds`, for them all
    _race: dict = field(default_factory=dict, repr=False)
    _admitted: dict = field(default_factory=dict, repr=False)

    scalar = True  # its outputs are summed away (:meth:`CompiledRace.run_sum`)

    def result(self, reassociate: Optional[int] = None):
        """RACE result for the group's program (memoized per level)."""
        return _memo_race(self, reassociate)


def group_program(program, specs, ir=None) -> tuple:
    """``(group program, feeds)`` of scalar ``specs`` of ``program``: each
    member's right-hand side with its own low pads taken back out of its
    subscripts, then one pad pass over them all (a low pad that one member
    needs shifts the others' subscripts too).  ``ir`` is the IR module the
    programs are built in (the port's by default; the reference's builders
    are the same)."""
    ir = ir or _ir
    loops = specs[0].program.loops
    if any(s.program.loops != loops or len(s.sum_axes) != len(loops)
           for s in specs):
        raise ValueError("a scalar group takes scalar specs of one loop nest")
    rhss = []
    for spec in specs:
        lo = {nm: [p[0] for p in pads]
              for kind, _, nm, pads in spec.feeds if kind != "scalar"}

        def unshift(x, lo=lo):
            if isinstance(x, ir.Ref) and x.subs and x.name in lo:
                return ir.Ref(x.name, tuple(
                    ir.Sub(s.a, s.s, s.b - lo[x.name][d])
                    for d, s in enumerate(x.subs)))
            return x

        (st,) = spec.program.body
        rhss.append(ir.map_expr(st.rhs, unshift))
    rhss, feeds = _pad_pass(program, loops, rhss, ir)
    body = tuple(ir.Stmt(s.program.body[0].lhs, rhs)
                 for s, rhs in zip(specs, rhss))
    return ir.Program(tuple(loops), body), feeds


@dataclass
class AdjointBuild:
    """All adjoint programs of one forward program, or a structured refusal."""

    program: Program
    specs: list
    reason: str = ""  # "" = supported; else an AdjointUnsupported message
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def ok(self) -> bool:
        return not self.reason

    def spec_for(self, name: str) -> Optional[InputSpec]:
        for s in self.specs:
            if s.input == name:
                return s
        return None

    def scalar_group(self, wrt: Iterable[str]) -> Optional[ScalarGroup]:
        """The :class:`ScalarGroup` of the scalar specs of the inputs in
        ``wrt`` (memoized per wanted subset), or None where fewer than two
        are wanted."""
        want = set(wrt)
        members = tuple(s for s in self.specs
                        if s.scalar and s.input in want)
        if len(members) < 2:
            return None
        key = tuple(s.input for s in members)
        group = self._groups.get(key)
        if group is None:
            prog, feeds = group_program(self.program, members)
            group = self._groups[key] = ScalarGroup(members, prog, feeds)
        return group


def _gate_lhs(program: Program) -> None:
    m = program.depth
    names = [st.lhs.name for st in program.body]
    if len(set(names)) != len(names):
        raise AdjointUnsupported(LHS_FORM, "output written by two statements")
    for st in program.body:
        levels = [s.s for s in st.lhs.subs]
        if (sorted(levels) != list(range(1, m + 1))
                or any(s.a != 1 for s in st.lhs.subs)):
            raise AdjointUnsupported(
                LHS_FORM, f"lhs {st.lhs.name} is not a unit box over all "
                          f"loop levels")
        for s in st.lhs.subs:
            _as_int(s.b, f"lhs {st.lhs.name} offset")
    outs = set(names)
    for st in program.body:
        for r in expr_refs(st.rhs):
            if r.name in outs and not (r.name == st.lhs.name
                                       and r.subs == st.lhs.subs):
                # pointwise self-reads (U[i] = U[i] + ...) are plain input
                # reads; anything else chains statements and is out of scope
                raise AdjointUnsupported(
                    READ_AFTER_WRITE,
                    f"{st.lhs.name} reads output {r.name}")
    # an adjoint program reads the cotangents and the inputs and writes one
    # accumulator, so those names must not be names the program reads;
    # names that merely carry the prefixes are fine, so an adjoint program
    # differentiates again (second order runs the adjoint of an adjoint on
    # the kernel)
    reads = {r.name for st in program.body for r in expr_refs(st.rhs)}
    made = ({COTANGENT_PREFIX + nm for nm in outs}
            | {ADJOINT_PREFIX + nm for nm in reads})
    clash = sorted(made & reads)
    if clash:
        raise AdjointUnsupported(
            LHS_FORM, f"reserved name {clash[0]!r} in program")


def _input_layout(uname: str, entries: list) -> tuple:
    """Validate the input's refs share one (dim -> level, sign) layout.
    Returns ``(level, sign)`` per dim."""
    rank = len(entries[0][1].subs)
    layout = []
    for d in range(rank):
        levels, signs = set(), set()
        for _, r in entries:
            if len(r.subs) != rank:
                raise AdjointUnsupported(MIXED_LAYOUT,
                                         f"{uname} read at two ranks")
            s = r.subs[d]
            if s.s == 0:
                raise AdjointUnsupported(
                    CONST_DIM, f"{uname} dim {d} is a constant subscript")
            levels.add(s.s)
            signs.add(s.a)
            _as_int(s.b, f"{uname} offset")
        if len(levels) != 1 or len(signs) != 1:
            raise AdjointUnsupported(
                MIXED_LAYOUT, f"{uname} dim {d} maps to multiple loop "
                              f"levels or signs")
        a = signs.pop()
        if abs(a) != 1:
            raise AdjointUnsupported(STRIDED_READ,
                                     f"{uname} dim {d} coefficient {a}")
        layout.append((levels.pop(), a))
    if len({lvl for lvl, _ in layout}) != rank:
        raise AdjointUnsupported(
            REPEATED_LEVEL, f"{uname} repeats a loop level across dims")
    return tuple(layout)


def _pad_pass(program, loops, rhss: list, ir) -> tuple:
    """One pad pass over the right-hand sides of one adjoint loop nest:
    per referenced array, per dim, the touched index interval over the
    loop ranges; negative minima become static left pads baked into the
    subscript offsets.  Returns the shifted right-hand sides and the
    runtime feed recipe that serves them all.  ``ir`` is the IR module the
    expressions are built in."""
    rng_of = {lp.level: (lp.lo, lp.hi) for lp in loops}
    bounds: dict = {}
    refs = {r for rhs in rhss for r in ir.expr_refs(rhs)}
    for r in refs:
        if not r.subs:
            continue
        for d, s in enumerate(r.subs):
            if s.s == 0:
                mn = mx = _as_int(s.b)
            else:
                mn, mx = _sub_range(s.a, s.b, *rng_of[s.s])
            cur = bounds.setdefault(r.name, {}).get(d)
            bounds[r.name][d] = ((mn, mx) if cur is None
                                 else (min(cur[0], mn), max(cur[1], mx)))
    pad_lo = {nm: {d: max(0, -mn) for d, (mn, _) in dims.items()}
              for nm, dims in bounds.items()}

    def shift(x):
        if isinstance(x, ir.Ref) and x.subs and x.name in pad_lo:
            return ir.Ref(x.name, tuple(
                ir.Sub(s.a, s.s, s.b + pad_lo[x.name][d])
                for d, s in enumerate(x.subs)))
        return x

    rhss = [ir.map_expr(rhs, shift) for rhs in rhss]

    full = program.ranges()
    by_lhs = {st.lhs.name: st for st in program.body}
    feeds = []
    for nm in sorted(bounds):
        dims = bounds[nm]
        ndim = max(dims) + 1
        plo = [pad_lo[nm][d] for d in range(ndim)]
        smax = [dims[d][1] + plo[d] for d in range(ndim)]  # post-shift max
        src = nm[len(COTANGENT_PREFIX):]
        if nm.startswith(COTANGENT_PREFIX) and src in by_lhs:
            st = by_lhs[src]
            # cotangent canvases have static interior extents
            ext = [full[s.s][1] - full[s.s][0] + 1 for s in st.lhs.subs]
            pads = tuple((plo[d], max(0, smax[d] + 1 - (plo[d] + ext[d])))
                         for d in range(ndim))
            feeds.append(("cotangent", src, nm, pads))
        else:
            feeds.append(("array", nm, nm, tuple(zip(plo, smax))))
    for r in sorted({x for rhs in rhss for x in ir.expr_refs(rhs)
                     if not x.subs}, key=_ref_sort_key):
        feeds.append(("scalar", r.name, r.name, None))
    return rhss, tuple(feeds)


def _assemble_spec(program: Program, uname: str, loops: list, terms: list,
                   embed: tuple, sum_axes: tuple) -> Optional[InputSpec]:
    """Shared tail of spec construction: sum the terms, bake negative
    minima into static left pads, and derive the runtime feed recipe."""
    if not terms:
        return None
    rhs = terms[0]
    for term in terms[1:]:
        rhs = rhs + term
    (rhs,), feeds = _pad_pass(program, loops, [rhs], _ir)
    gu = ADJOINT_PREFIX + uname
    lhs = Ref(gu, tuple(Sub(1, k + 1, 0) for k in range(len(loops))))
    adj = Program(tuple(loops), (Stmt(lhs, rhs),))
    return InputSpec(input=uname, program=adj, gu=gu, embed=embed,
                     sum_axes=sum_axes, feeds=feeds)


def _build_input_spec(program: Program, uname: str, entries: list):
    """The transposed stencil for one input, or None if every derivative
    vanished.  ``entries`` is ``[(stmt index, Ref), ...]`` deduplicated."""
    full = program.ranges()
    m = program.depth
    layout = _input_layout(uname, entries)
    rank = len(layout)

    # hull of accessed indices per input dim, in the input's index space
    hull = []
    for d, (lvl, a) in enumerate(layout):
        lo, hi = full[lvl]
        mns, mxs = [], []
        for _, r in entries:
            mn, mx = _sub_range(a, r.subs[d].b, lo, hi)
            mns.append(mn)
            mxs.append(mx)
        glo, ghi = min(mns), max(mxs)
        if glo < 0:
            raise AdjointUnsupported(
                NEGATIVE_INDEX, f"{uname} dim {d} reaches index {glo}")
        hull.append((glo, ghi))

    covered = {lvl: d for d, (lvl, _) in enumerate(layout)}
    missing = [l for l in range(1, m + 1) if l not in covered]

    # adjoint loop nest: input dims first (over the hull), then the forward
    # levels the input does not carry (gradient contributions summed later)
    loops = [Loop(d + 1, f"q{d + 1}", lo, hi)
             for d, (lo, hi) in enumerate(hull)]
    for k, l in enumerate(missing):
        lo, hi = full[l]
        loops.append(Loop(rank + k + 1, f"t{k + 1}", lo, hi))
    # forward level -> (adjoint level, alpha): i_l = alpha * q + gamma with
    # gamma per *reference* (resolved below); missing levels map one-to-one
    adj_of = {lvl: (d + 1, layout[d][1]) for lvl, d in covered.items()}
    adj_of.update({l: (rank + k + 1, 1) for k, l in enumerate(missing)})

    def remap(e: Expr, gammas: Mapping[int, int]) -> Expr:
        def fn(x):
            if isinstance(x, Ref) and x.subs:
                subs = []
                for s in x.subs:
                    if s.s == 0:
                        subs.append(s)
                        continue
                    adl, alpha = adj_of[s.s]
                    subs.append(Sub(s.a * alpha, adl,
                                    s.a * gammas.get(s.s, 0) + s.b))
                return Ref(x.name, tuple(subs))
            return x

        return map_expr(e, fn)

    terms = []
    for t, r in entries:
        st = program.body[t]
        c = derivative(st.rhs, r)
        if _is_const(c, 0.0):
            continue
        # solving a*i_l + b = q for the read index gives i_l = a*q - a*b
        gammas = {layout[d][0]: -layout[d][1] * _as_int(r.subs[d].b)
                  for d in range(rank)}
        c_adj = simplify(remap(c, gammas))
        # cotangent read: interior index of output dim l is i_l - lo_l
        gsubs = []
        for s in st.lhs.subs:
            adl, alpha = adj_of[s.s]
            gamma = gammas.get(s.s, 0)
            gsubs.append(Sub(alpha, adl, gamma - full[s.s][0]))
        gref = Ref(COTANGENT_PREFIX + st.lhs.name, tuple(gsubs))
        terms.append(gref if _is_const(c_adj, 1.0) else c_adj * gref)
    return _assemble_spec(program, uname, loops, terms, tuple(hull),
                          tuple(range(rank, len(loops))))


def _build(program: Program) -> AdjointBuild:
    _gate_lhs(program)
    refs_by_input: dict = {}
    for t, st in enumerate(program.body):
        for r in sorted(set(expr_refs(st.rhs)), key=_ref_sort_key):
            if not r.subs:
                continue  # scalars handled below
            refs_by_input.setdefault(r.name, []).append((t, r))
    for t, st in enumerate(program.body):
        for r in sorted({x for x in expr_refs(st.rhs) if not x.subs},
                        key=_ref_sort_key):
            refs_by_input.setdefault(r.name, []).append((t, r))
    specs = []
    for uname in sorted(refs_by_input):
        entries = refs_by_input[uname]
        if entries[0][1].subs:
            spec = _build_input_spec(program, uname, entries)
        else:
            spec = _build_scalar_spec(program, uname, entries)
        if spec is not None:
            specs.append(spec)
    return AdjointBuild(program, specs)


def _build_scalar_spec(program: Program, uname: str, entries: list):
    """Scalars are rank-0 inputs: every forward level is 'missing', so the
    adjoint sweeps the full iteration box (levels map one-to-one) and the
    runtime sums the whole box away."""
    full = program.ranges()
    m = program.depth
    loops = [Loop(k + 1, f"t{k + 1}", *full[k + 1]) for k in range(m)]
    terms = []
    for t, r in entries:
        st = program.body[t]
        c = derivative(st.rhs, r)
        if _is_const(c, 0.0):
            continue
        gsubs = tuple(Sub(1, s.s, -full[s.s][0]) for s in st.lhs.subs)
        gref = Ref(COTANGENT_PREFIX + st.lhs.name, gsubs)
        terms.append(gref if _is_const(c, 1.0) else simplify(c) * gref)
    return _assemble_spec(program, uname, loops, terms, (),
                          tuple(range(m)))


_builds: dict = {}
_builds_lock = threading.Lock()


def adjoint_build(program: Program) -> AdjointBuild:
    """Construct (memoized by structural program hash) the adjoint programs
    of ``program``, or a refusal carrying the structured reason."""
    from .executor import program_hash

    h = program_hash(program)
    with _builds_lock:
        b = _builds.get(h)
    if b is not None:
        return b
    try:
        with _obs.span("adjoint_build", program=h):
            b = _build(program)
        if _obs.enabled():
            _obs.counter("race_adjoint_builds_total",
                         outcome="supported").inc()
    except AdjointUnsupported as e:
        b = AdjointBuild(program, [], reason=str(e))
        # the refusal is a pipeline decision: emitted once per program (the
        # build is memoized), with the structured reason code the backward
        # falls back to autograd under
        if _obs.enabled():
            _obs.counter("race_adjoint_builds_total",
                         outcome="refused").inc()
            _obs.event("adjoint_refusal", program=h, reason=e.reason,
                       detail=e.detail)
    with _builds_lock:
        _builds[h] = b
    return b


# ---------------------------------------------------------------------------
# runtime backward pass
# ---------------------------------------------------------------------------


def _torch_pads(pads) -> tuple:
    """``((lo, hi) per dim)`` in ``F.pad``'s order: last dim first."""
    return tuple(x for lo, hi in reversed(pads) for x in (lo, hi))


def _feed_pads(kind: str, pads, shape) -> tuple:
    """``(lo, hi)`` per trailing dimension by which a feed of ``shape`` is
    padded: a cotangent's static zero pads, a coefficient array's ones-pads
    with the high one resolved against ``shape``; ``()`` for a scalar."""
    if kind == "cotangent":
        return tuple(pads)
    if kind == "scalar":
        return ()
    lead = len(shape) - len(pads)
    return tuple((plo, max(0, smax + 1 - (plo + shape[lead + d])))
                 for d, (plo, smax) in enumerate(pads))


def cotangent_pads(spec: InputSpec) -> dict:
    """``{adjoint env name: ((lo, hi) per dimension)}`` of the spec's
    cotangent feeds padded with zeros: what K1 reads in place
    (:func:`assemble_adjoint_env`'s ``in_place``)."""
    return {nm: tuple(pads) for kind, _, nm, pads in spec.feeds
            if kind == "cotangent" and any(lo or hi for lo, hi in pads)}


def assemble_adjoint_env(spec: InputSpec, env: Mapping, g: Mapping,
                         in_place=(), count: bool = False) -> dict:
    """One adjoint plan's env from the forward env and the cotangents, per
    the spec's feed recipe: zero-padded cotangent canvases, ones-padded
    coefficient arrays, scalars as they are.  Every entry is contiguous (a
    cotangent from autograd may be an expanded view).  Pads act on the
    trailing, per-example dimensions, so a batch axis in front passes
    through.  A cotangent named in ``in_place`` is left unpadded, for K1 to
    read at its :func:`cotangent_pads` (the guards supply the zeros).
    ``count``: the env of a backward; with obs on, each padded feed counts
    once in ``race_adjoint_pads_total{how, kind}`` (``how`` ``"kernel"``
    where K1 reads it in place, else ``"canvas"``; ``kind``
    ``"cotangent"`` or ``"coefficient"``)."""
    adj_env = {}
    for kind, src, adj_name, pads in spec.feeds:
        arr = g[src] if kind == "cotangent" else env[src]
        padspec = _feed_pads(kind, pads, arr.shape)
        if any(lo or hi for lo, hi in padspec):
            how = "kernel" if adj_name in in_place else "canvas"
            if how == "canvas":  # a coefficient's ones keep divisions
                # finite where the zero cotangent annihilates the terms
                arr = F.pad(arr, _torch_pads(padspec),
                            value=0 if kind == "cotangent" else 1)
            if count and _obs.enabled():
                _obs.counter("race_adjoint_pads_total", how=how,
                             kind="cotangent" if kind == "cotangent"
                             else "coefficient").inc()
        adj_env[adj_name] = arr.contiguous()
    return adj_env


def _fed_shape(kind: str, pads, shape) -> tuple:
    """The shape of a feed of ``shape`` in the env
    :func:`assemble_adjoint_env` gives: padded by :func:`_feed_pads`."""
    padspec = _feed_pads(kind, pads, shape)
    k = len(shape) - len(padspec)
    return tuple(shape[:k]) + tuple(
        n + lo + hi for n, (lo, hi) in zip(shape[k:], padspec))


def adjoint_signature(spec: InputSpec, env: Mapping, g: Mapping,
                      batched: bool = False) -> tuple:
    """The :func:`~.executor.env_signature` of the env
    :func:`assemble_adjoint_env` gives (``batched``: per example, as
    :func:`~.executor.stacked_signature`), from the shapes and dtypes of
    ``env`` and ``g`` alone: nothing is padded."""
    from .executor import _dt_name

    sig = []
    for kind, src, adj_name, pads in spec.feeds:
        arr = g[src] if kind == "cotangent" else env[src]
        sig.append((adj_name, _fed_shape(kind, pads, tuple(arr.shape)[
            1 if batched else 0:]), _dt_name(arr.dtype)))
    return tuple(sorted(sig))


def adjoint_env_shapes(spec: InputSpec, program: Program,
                       shapes: Mapping) -> dict:
    """The shapes :func:`assemble_adjoint_env` gives, from the forward env's
    shapes alone (for building an adjoint plan's kernel ahead of a run)."""
    full = program.ranges()
    by_lhs = {st.lhs.name: st for st in program.body}
    out = {}
    for kind, src, adj_name, pads in spec.feeds:
        shape = (tuple(full[s.s][1] - full[s.s][0] + 1
                       for s in by_lhs[src].lhs.subs)
                 if kind == "cotangent" else tuple(shapes[src]))
        out[adj_name] = _fed_shape(kind, pads, shape)
    return out


def adjoint_executor(unit, env: Mapping, g: Mapping,
                     backend: Optional[str] = None, batched: bool = False):
    """The executor one adjoint program (an :class:`InputSpec` or a
    :class:`ScalarGroup`) runs on in a backward: the one of the padded
    env's signature (per example where ``batched``, as ``run_batch``'s).
    Where it runs K1 and no graph is recorded, it reads each zero-padded
    cotangent as it came (:func:`cotangent_pads`, its
    :attr:`~.executor.CompiledRace.pads`), K1's guards supplying the zeros;
    the ``"torch"`` evaluator, and a recorded graph (which differentiates
    the pad), take the canvas.  Its env is :func:`assemble_adjoint_env`
    with ``in_place=ex.pads``."""
    from .executor import compile_plan

    feeds = [(g if kind == "cotangent" else env)[src]
             for kind, src, _, _ in unit.feeds]
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in feeds)
    return compile_plan(unit.result().plan,
                        adjoint_signature(unit, env, g, batched), backend,
                        device=feeds[0].device,
                        pads=None if recording else cotangent_pads(unit))


def finalize_adjoint(spec: InputSpec, env: Mapping, val):
    """Shape one adjoint plan's raw output back into the input's geometry:
    sum away broadcast levels, match the primal dtype (``None`` for an
    integer input), and embed the access hull into input-shaped zeros.
    Leading (batch) dimensions of ``val`` and the primal are kept: a
    batched scalar's gradient is ``(B,)``.  A scalar's ``val`` may be the
    summed kernel's partials, one axis behind the primal's (batch) ones
    (:meth:`CompiledRace.run_sum`): they are summed, then rounded once to
    the primal's dtype."""
    primal = env[spec.input]
    if not primal.is_floating_point():
        return None
    if spec.scalar and val.dim() == primal.dim() + 1:
        val = val.sum(-1)  # the partials (or a depth-1 box)
    elif spec.sum_axes:
        lead = val.dim() - len(spec.program.loops)
        val = val.sum(dim=tuple(lead + a for a in spec.sum_axes))
    val = val.to(primal.dtype)
    shape = tuple(primal.shape)
    rank = len(spec.embed)
    if all(lo == 0 and hi + 1 == shape[d - rank]
           for d, (lo, hi) in enumerate(spec.embed)):
        return val
    canvas = torch.zeros(shape, dtype=primal.dtype, device=primal.device)
    canvas[(Ellipsis,) + tuple(slice(lo, hi + 1)
                               for lo, hi in spec.embed)] = val
    return canvas


def _admitted(group: ScalarGroup, env: Mapping, g: Mapping,
              backend: Optional[str]) -> bool:
    """Whether ``group`` runs: the backend asks for the kernel (``"hopper"``
    or ``"auto"``) and the group's plan and every member's plan select
    ``"hopper"`` at the env's dtypes (:func:`~.backend.select_backend`'s
    probe), which holds on the card and for the tile emulator on the CPU.
    Decided from the plans and dtypes alone, before any launch; memoized
    per group and dtypes."""
    from .backend import probe_hopper
    from .executor import _dt_name, default_backend, operand_dtypes

    if (backend or default_backend()) == "torch":
        return False
    sig = tuple((nm, None, _dt_name(
        (g if kind == "cotangent" else env)[src].dtype))
        for kind, src, nm, _ in sorted(group.feeds, key=lambda f: f[2]))
    ok = group._admitted.get(sig)
    if ok is None:
        ok = group._admitted[sig] = all(
            probe_hopper(u.result().plan,
                         operand_dtypes(u.result().plan, sig)).eligible
            for u in (group,) + group.members)
    return ok


def adjoint_runs(build: AdjointBuild, env: Mapping, g: Mapping,
                 wrt: Iterable[str], backend: Optional[str] = None) -> list:
    """The adjoint programs a first-order backward runs for the inputs in
    ``wrt``, in order: each wanted array spec, then the wanted scalar specs
    as one :class:`ScalarGroup` where there are two or more of them and
    the group is admitted (:func:`_admitted`), else each scalar spec on its
    own."""
    want = set(wrt)
    specs = [s for s in build.specs if s.input in want]
    group = build.scalar_group(want)
    if group is None or not _admitted(group, env, g, backend):
        return specs
    return [s for s in specs if not s.scalar] + [group]


def _run_unit(unit, env: Mapping, g: Mapping, backend: Optional[str] = None,
              batched: bool = False) -> dict:
    """Run one adjoint program (an :class:`InputSpec` or a
    :class:`ScalarGroup`) on its :func:`adjoint_executor` and give each of
    its members' gradients."""
    ex = adjoint_executor(unit, env, g, backend, batched)
    adj_env = assemble_adjoint_env(unit, env, g, in_place=ex.pads,
                                   count=True)
    if unit.scalar:  # K1 sums the products in the kernel
        out = ex.run_sum(adj_env, batched)
    elif batched:
        out = ex.run_batch(adj_env)
    else:
        out = ex(adj_env)
    return {s.input: finalize_adjoint(s, env, out[s.gu])
            for s in unit.members}


_baseline_memo: dict = {}


def _autodiff_backward(program: Program, env: Mapping, g: Mapping,
                       wrt: Iterable[str], batched: bool = False) -> dict:
    """Fallback VJP: autograd through the *baseline* evaluator (vmapped
    when ``batched``), interior sliced (association may differ from the
    executed plan, but gradients agree at the harness's ``grad``
    tolerance).  Under ``create_graph`` (grad on in the caller) the inputs
    are not detached and the gradients keep their graph."""
    from .executor import program_hash

    key = (program_hash(program), batched)
    run = _baseline_memo.get(key)
    if run is None:
        from .codegen import build_baseline_evaluator

        run = build_baseline_evaluator(program)
        if batched:
            run = torch.func.vmap(run)
        _baseline_memo[key] = run
    full = program.ranges()
    keys = [k for k in wrt if env[k].is_floating_point()]
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        leaves = {k: (v if create and v.requires_grad
                      else v.detach().requires_grad_()) if k in keys else v
                  for k, v in env.items()}
        out = run(dict(leaves))
        outs, gouts = [], []
        for st in program.body:
            sl = tuple(slice(full[s.s][0] + _as_int(s.b),
                             full[s.s][1] + _as_int(s.b) + 1)
                       for s in st.lhs.subs)
            o = out[st.lhs.name][(Ellipsis,) + sl]
            # an output built from no wanted input (a constant, or reads of
            # unwanted inputs only) has no graph: it adds nothing
            if o.requires_grad:
                outs.append(o)
                gouts.append(g[st.lhs.name])
        if not outs or not keys:
            return {}
        grads = torch.autograd.grad(
            outs, [leaves[k] for k in keys], gouts, allow_unused=True,
            create_graph=create)
    return dict(zip(keys, grads))


class _CancelledGradient(torch.autograd.Function):
    """Zeros shaped like the input, as the gradient of a read input whose
    terms all cancel.  Under a recorded graph the zeros stay connected to
    the input, and their own backward is this function again, so a
    gradient of any order through them is zeros too (``x * 0`` would give
    NaN where ``x`` holds an infinity)."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return _CancelledGradient.apply(g)


def complete_gradients(program: Program, env: Mapping, grads: Mapping,
                       wrt: Iterable[str]) -> dict:
    """The full-env result of a backward, from the gradients it computed
    (``None`` or missing where it computed none): a wanted floating-point
    input the program reads but that got no gradient, as every term of its
    adjoint cancels, gets zeros of its dtype, shape and device (batch axis
    included); integer, unread and unwanted inputs get ``None``.  Every
    backward path ends here, so they cannot differ."""
    want = set(wrt)
    reads = {r.name for st in program.body for r in expr_refs(st.rhs)}
    out = {}
    for k, v in env.items():
        gk = grads.get(k)
        if (gk is None and k in want and k in reads
                and v.is_floating_point()):
            gk = _CancelledGradient.apply(v)
        out[k] = gk
    return out


def backward(program: Program, env: Mapping, g: Mapping, *,
             backend: Optional[str] = None,
             wrt: Optional[Iterable[str]] = None,
             batched: bool = False) -> dict:
    """VJP of the program's interior-convention outputs w.r.t. ``env``.

    ``g`` maps output names to cotangents; ``wrt`` names the inputs wanted
    (default: all).  Returns ``{name: gradient or None}`` for every env
    entry (:func:`complete_gradients`): zeros for a wanted input the
    program reads whose terms all cancel, ``None`` for integer, unread and
    unwanted inputs.  ``backend``
    runs the adjoint plans (``None``: ``$RACE_BACKEND`` or ``"auto"``).
    ``batched``: every entry of ``env`` and ``g`` carries a leading batch
    axis, and the adjoint plans run through ``run_batch``.  Two or more
    wanted scalars run as one :class:`ScalarGroup` where
    :func:`adjoint_runs` admits it, except under a recorded graph (a
    second-order backward), where every spec runs on its own."""
    wrt = list(env) if wrt is None else [k for k in env if k in set(wrt)]
    if adjoint_mode() == "autodiff":
        if _obs.enabled():
            _obs.counter("race_adjoint_backward_total",
                         mode="autodiff-forced").inc()
        grads = _autodiff_backward(program, env, g, wrt, batched)
    else:
        build = adjoint_build(program)
        if not build.ok:
            if _obs.enabled():
                _obs.counter("race_adjoint_backward_total",
                             mode="autodiff-fallback").inc()
            grads = _autodiff_backward(program, env, g, wrt, batched)
        else:
            with _obs.span("adjoint_backward"):
                # under a recorded graph (a second-order backward) every
                # spec runs on its own, as run_sum then takes the full
                # products
                recording = torch.is_grad_enabled() and any(
                    v.requires_grad for v in (*env.values(), *g.values()))
                runs = ([s for s in build.specs if s.input in wrt]
                        if recording
                        else adjoint_runs(build, env, g, wrt, backend))
                grads = {}
                for unit in runs:
                    grads.update(_run_unit(unit, env, g, backend, batched))
                out = complete_gradients(program, env, grads, wrt)
            if _obs.enabled():
                _obs.counter("race_adjoint_backward_total",
                             mode="stencil").inc()
            return out
    return complete_gradients(program, env, grads, wrt)
