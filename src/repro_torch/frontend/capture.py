"""Own copy of ``repro/frontend/capture.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_frontend.py`` holds the
two against drift.

AST capture of plain Python/NumPy loop nests into RACE IR.

``capture(fn, shapes)`` turns an ordinary Python function written as a
perfectly nested ``for`` loop over NumPy-style arrays::

    def blur(u, out):
        n, m = u.shape
        for i in range(1, n - 1):
            for j in range(1, m - 1):
                out[i, j] = (u[i - 1, j] + u[i + 1, j]) / 2.0

into a :class:`repro_torch.core.ir.Program`, preserving the written expression
trees exactly (association order matters to the binary detector).  The
recognized scope is the paper's (Section 4.1): one perfect nest of
unit-stride ``range`` loops, straight-line innermost body of array
assignments, affine subscripts ``a*i+b`` per dimension.

Anything outside that scope raises :class:`CaptureError` carrying a
:class:`FrontendDiagnostic` with a stable code and the source line/col —
mirrors the backend capability probe's "never silently" contract.

Parameters are classified by ``shapes``: ``name -> ()`` is a scalar input
(captured as a 0-d :class:`Ref`), ``name -> (d0, ...)`` an array.  Loop
bounds and subscript constants may use capture-time values: ``.shape`` of
array parameters, entries of ``consts``, and the function's
globals/closure (``N = 64`` at module scope just works).
"""
from __future__ import annotations

import ast
import inspect
import numbers
import operator
import textwrap
from typing import Callable, Mapping, Optional

from ..core.ir import (Const, Expr, FuncName, Loop, Node, Program, Ref,
                       SourceLoc, Stmt, Sub)

from .affine import Reject, affine_to_sub, const_eval
from .diagnostics import (CaptureError, D_CONTROL_FLOW, D_IMPERFECT_NEST,
                          D_LHS_FORM, D_LOOP_FORM, D_LOOPVAR_VALUE,
                          D_NO_LOOP, D_NON_AFFINE, D_RANK_MISMATCH,
                          D_UNKNOWN_CALL, D_UNKNOWN_NAME, D_UNSUPPORTED_EXPR,
                          D_UNSUPPORTED_STMT, FrontendDiagnostic)

#: call names the executable IR understands; mirrors ``codegen.FUNCS`` (kept
#: as literals so capture never imports torch; cross-checked by the tests)
KNOWN_CALLS = ("sin", "cos", "exp", "log", "sqrt", "tanh", "abs")


def _is_known_impl(name: str, obj) -> bool:
    """Is ``obj`` a recognized implementation of the elementwise ``name``?

    Accepts the ``math``/``numpy`` functions (and builtin ``abs``), plus any
    same-named callable of ``torch`` (where the reference accepts jax's) —
    but NOT an arbitrary user callable that merely shares the name
    (capturing that as the math builtin would be a silent semantics
    change)."""
    import math

    import numpy as np

    impls = {f for f in (getattr(math, name, None), getattr(np, name, None))
             if f is not None}
    if name == "abs":
        impls.add(abs)
    if any(obj is f for f in impls):
        return True
    mod = getattr(obj, "__module__", None) or ""
    return (mod.split(".")[0] == "torch"
            and getattr(obj, "__name__", "") == name)

_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}


class _ArrayStub:
    """Capture-time stand-in for an array parameter: shape facts only."""

    def __init__(self, name: str, shape: tuple):
        self.name, self.shape = name, tuple(shape)
        self.ndim = len(self.shape)

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 0

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"<array {self.name}{self.shape}>"


def _closure_env(fn: Callable) -> dict:
    env = dict(getattr(fn, "__globals__", {}))
    names = getattr(fn.__code__, "co_freevars", ())
    cells = getattr(fn, "__closure__", None) or ()
    for name, cell in zip(names, cells):
        try:
            env[name] = cell.cell_contents
        except ValueError:  # pragma: no cover - unfilled cell
            pass
    return env


class _Capturer:
    def __init__(self, fn: Callable, shapes: Mapping[str, tuple],
                 consts: Optional[Mapping] = None):
        self.fn = fn
        self.filename = inspect.getsourcefile(fn) or "<unknown>"
        try:
            src = inspect.getsource(fn)
        except (OSError, TypeError) as e:
            raise ValueError(
                f"cannot read source of {fn!r} (interactive/compiled "
                f"functions are not capturable): {e}") from e
        dedented = textwrap.dedent(src)
        self.indent = len(src.splitlines()[0]) - len(dedented.splitlines()[0])
        tree = ast.parse(dedented)
        ast.increment_lineno(tree, fn.__code__.co_firstlineno - 1)
        fndef = tree.body[0]
        if not isinstance(fndef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            raise ValueError(f"{fn!r} source does not start with a def")
        self.fndef = fndef

        args = fndef.args
        if args.vararg or args.kwarg:
            self._fail(D_UNSUPPORTED_STMT,
                       "*args/**kwargs parameters are not capturable", fndef)
        self.params = [a.arg for a in
                       args.posonlyargs + args.args + args.kwonlyargs]
        self.arrays: dict = {}
        self.scalars: set = set()
        consts = dict(consts or {})
        shapes = dict(shapes)
        for p in self.params:
            if p in consts:
                continue
            if p not in shapes:
                raise ValueError(
                    f"capture needs a shape for parameter {p!r}: pass "
                    f"shapes[{p!r}] = () for a scalar or (d0, ...) for an "
                    f"array (or a value in consts)")
            shp = tuple(shapes[p])
            if shp == ():
                self.scalars.add(p)
            else:
                self.arrays[p] = _ArrayStub(p, shp)
        # constant-evaluation environment: globals/closure shadowed by
        # capture-supplied consts and the array stubs
        self.env = _closure_env(fn)
        self.env.update(consts)
        self.env.update(self.arrays)
        self.loop_levels: dict = {}  # var -> level
        self.loops: list = []

    # -- diagnostics --------------------------------------------------------

    def _fail(self, code: str, message: str, node: ast.AST):
        raise CaptureError(FrontendDiagnostic(
            code=code, message=message,
            line=getattr(node, "lineno", self.fndef.lineno),
            col=getattr(node, "col_offset", 0) + self.indent,
            file=self.filename, function=self.fn.__name__))

    def _reraise(self, r: Reject):
        self._fail(r.code, r.message, r.node)

    # -- driver -------------------------------------------------------------

    def run(self) -> Program:
        body = list(self.fndef.body)
        # skip a docstring
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        if not any(isinstance(s, ast.For) for s in body):
            self._fail(D_NO_LOOP,
                       "function has no for-loop nest to capture",
                       self.fndef)
        nest = None
        for st in body:
            if isinstance(st, ast.For):
                if nest is not None:
                    self._fail(D_IMPERFECT_NEST,
                               "more than one top-level loop nest", st)
                nest = st
            elif nest is not None:
                self._fail(D_IMPERFECT_NEST,
                           "statement after the loop nest", st)
            else:
                self._pre_loop_stmt(st)
        stmts = self._loop(nest, level=1)
        return Program(
            tuple(self.loops), tuple(stmts),
            loc=SourceLoc(self.filename, self.fndef.lineno, self.indent))

    # -- pre-loop constant bindings ----------------------------------------

    def _pre_loop_stmt(self, st: ast.stmt) -> None:
        """Before the nest only shape/constant bindings are admissible:
        ``n, m = u.shape``, ``half = n // 2``, ..."""
        if isinstance(st, (ast.If, ast.While)):
            self._fail(D_CONTROL_FLOW,
                       "control flow before the loop nest", st)
        if isinstance(st, ast.AnnAssign) and st.value is not None:
            targets = [st.target]
            value = st.value
        elif isinstance(st, ast.Assign):
            targets = st.targets
            value = st.value
        else:
            self._fail(D_UNSUPPORTED_STMT,
                       f"unsupported statement before the loop nest "
                       f"({type(st).__name__})", st)
        try:
            val = const_eval(value, self.env)
        except Reject:
            self._fail(D_UNSUPPORTED_STMT,
                       "pre-loop statement is not a capture-time constant "
                       "binding (only shape/int bindings may precede the "
                       "nest)", st)
        for tgt in targets:
            self._bind(tgt, val)

    def _bind(self, target: ast.expr, val) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            try:
                vals = list(val)
            except TypeError:
                self._fail(D_UNSUPPORTED_STMT,
                           f"cannot unpack non-sequence {val!r}", target)
            if len(vals) != len(target.elts):
                self._fail(D_UNSUPPORTED_STMT,
                           f"unpacking arity mismatch ({len(target.elts)} "
                           f"targets, {len(vals)} values)", target)
            for t, v in zip(target.elts, vals):
                self._bind(t, v)
            return
        self._fail(D_UNSUPPORTED_STMT,
                   "only name/tuple targets may be bound before the nest",
                   target)

    # -- the loop nest ------------------------------------------------------

    def _loop(self, node: ast.For, level: int) -> list:
        if node.orelse:
            self._fail(D_CONTROL_FLOW, "for-else is not loop-nest code",
                       node.orelse[0])
        if not isinstance(node.target, ast.Name):
            self._fail(D_LOOP_FORM, "loop target must be a single name",
                       node.target)
        var = node.target.id
        if var in self.loop_levels or var in self.arrays \
                or var in self.scalars:
            self._fail(D_LOOP_FORM,
                       f"loop variable {var!r} shadows an outer loop "
                       f"variable or parameter", node.target)
        lo, hi = self._range_bounds(node)
        self.loop_levels[var] = level
        self.loops.append(Loop(level, var, lo, hi))

        inner_fors = [s for s in node.body if isinstance(s, ast.For)]
        others = [s for s in node.body if not isinstance(s, ast.For)]
        if inner_fors:
            if others:
                self._fail(D_IMPERFECT_NEST,
                           "imperfect nest: statements share a loop body "
                           "with an inner loop", others[0])
            if len(inner_fors) > 1:
                self._fail(D_IMPERFECT_NEST,
                           "imperfect nest: sibling loops at the same depth",
                           inner_fors[1])
            return self._loop(inner_fors[0], level + 1)
        return [self._body_stmt(s) for s in node.body]

    def _range_bounds(self, node: ast.For) -> tuple:
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords):
            self._fail(D_LOOP_FORM,
                       "only range(...) iteration is capturable", it)
        if not 1 <= len(it.args) <= 3:
            self._fail(D_LOOP_FORM, "range() with 1-3 arguments expected", it)
        vals = []
        for a in it.args:
            # a bound naming an enclosing loop variable is loop-varying, not
            # a constant — folding a same-named pre-loop binding instead
            # would silently capture different semantics than Python's
            dep = [x.id for x in ast.walk(a) if isinstance(x, ast.Name)
                   and x.id in self.loop_levels]
            if dep:
                self._fail(D_LOOP_FORM,
                           f"loop bound depends on loop variable "
                           f"{dep[0]!r}; only rectangular nests are "
                           f"capturable", a)
            try:
                v = const_eval(a, self.env)
            except Reject as r:
                self._fail(D_LOOP_FORM,
                           f"loop bound is not a capture-time constant: "
                           f"{r.message}", a)
            if isinstance(v, bool):
                self._fail(D_LOOP_FORM,
                           f"loop bound must be an integer, got {v!r}", a)
            try:
                v = operator.index(v)  # int, np.int32/64, ...
            except TypeError:
                self._fail(D_LOOP_FORM,
                           f"loop bound must be an integer, got {v!r}", a)
            vals.append(v)
        if len(vals) == 1:
            lo, stop, step = 0, vals[0], 1
        elif len(vals) == 2:
            (lo, stop), step = vals, 1
        else:
            lo, stop, step = vals
        if step != 1:
            self._fail(D_LOOP_FORM,
                       f"only unit-stride loops are capturable (step "
                       f"{step}); express strides in the subscripts "
                       f"(a[2*i]) instead", it.args[2])
        if stop <= lo:
            # valid zero-iteration Python, but an inverted Loop(lo > hi)
            # crashes codegen slicing — diagnose at capture instead
            self._fail(D_LOOP_FORM,
                       f"loop range({lo}, {stop}) is empty for the captured "
                       f"shapes; an empty nest has no program to optimize",
                       it)
        return lo, stop - 1  # Loop bounds are inclusive

    # -- innermost body -----------------------------------------------------

    def _body_stmt(self, st: ast.stmt) -> Stmt:
        if isinstance(st, (ast.If, ast.While, ast.Break, ast.Continue)):
            self._fail(D_CONTROL_FLOW,
                       f"internal control flow ({type(st).__name__.lower()}) "
                       f"is outside the paper's scope", st)
        loc = SourceLoc(self.filename, st.lineno,
                        getattr(st, "col_offset", 0) + self.indent)
        if isinstance(st, ast.AugAssign):
            if type(st.op) not in _BINOPS:
                self._fail(D_UNSUPPORTED_STMT,
                           "only +=, -=, *=, /= augmented assignments are "
                           "capturable", st)
            lhs = self._lhs(st.target)
            rhs = Node(_BINOPS[type(st.op)],
                       (lhs, self._expr(st.value)))
            return Stmt(lhs, rhs, loc=loc)
        if not isinstance(st, ast.Assign):
            self._fail(D_UNSUPPORTED_STMT,
                       f"unsupported statement in the loop body "
                       f"({type(st).__name__})", st)
        if len(st.targets) != 1:
            self._fail(D_UNSUPPORTED_STMT,
                       "chained assignment is not capturable", st)
        target = st.targets[0]
        if isinstance(target, ast.Name):
            self._fail(D_UNSUPPORTED_STMT,
                       f"scalar temporary {target.id!r} in the loop body; "
                       f"inline it into the consuming expression (the "
                       f"detector rediscovers the sharing)", st)
        lhs = self._lhs(target)
        return Stmt(lhs, self._expr(st.value), loc=loc)

    def _lhs(self, target: ast.expr) -> Ref:
        if not isinstance(target, ast.Subscript):
            self._fail(D_LHS_FORM,
                       "assignment target must be a subscripted array",
                       target)
        ref = self._ref(target)
        levels = [s.s for s in ref.subs]
        if (sorted(levels) != sorted(self.loop_levels.values())
                or any(s.a != 1 for s in ref.subs)):
            self._fail(D_LHS_FORM,
                       f"output {ref.name!r} must sweep every loop variable "
                       f"exactly once with unit stride", target)
        return ref

    # -- expressions --------------------------------------------------------

    def _ref(self, node: ast.Subscript) -> Ref:
        if not isinstance(node.value, ast.Name):
            self._fail(D_UNSUPPORTED_EXPR,
                       "only direct array-name subscripts are capturable",
                       node.value)
        name = node.value.id
        stub = self.arrays.get(name)
        if stub is None:
            code = (D_UNSUPPORTED_EXPR if name in self.scalars
                    else D_UNKNOWN_NAME)
            self._fail(code, f"subscript of non-array name {name!r}",
                       node.value)
        idx = node.slice
        dims = list(idx.elts) if isinstance(idx, ast.Tuple) else [idx]
        if any(isinstance(d, ast.Slice) for d in dims):
            self._fail(D_UNSUPPORTED_EXPR,
                       "slicing is not scalar loop-nest code", node)
        if len(dims) != stub.ndim:
            self._fail(D_RANK_MISMATCH,
                       f"{name} is {stub.ndim}-dimensional but is indexed "
                       f"with {len(dims)} subscript(s)", node)
        subs = []
        for d in dims:
            try:
                subs.append(affine_to_sub(d, self.loop_levels, self.env))
            except Reject as r:
                self._reraise(r)
        return Ref(name, tuple(subs))

    def _call_name(self, func: ast.expr) -> str:
        if isinstance(func, ast.Name):
            return func.id
        if isinstance(func, ast.Attribute):  # np.sin, math.cos, ...
            return func.attr
        self._fail(D_UNKNOWN_CALL, "uncapturable callee expression", func)

    def _expr(self, node: ast.expr) -> Expr:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(
                    node.value, (int, float)):
                self._fail(D_UNSUPPORTED_EXPR,
                           f"non-numeric constant {node.value!r}", node)
            return Const(float(node.value))
        if isinstance(node, ast.Name):
            name = node.id
            if name in self.loop_levels:
                self._fail(D_LOOPVAR_VALUE,
                           f"loop variable {name!r} used as a value; it may "
                           f"only appear inside affine subscripts", node)
            if name in self.scalars:
                return Ref(name, ())
            if name in self.arrays:
                self._fail(D_UNSUPPORTED_EXPR,
                           f"whole-array reference {name!r}; loop-nest code "
                           f"reads arrays through subscripts", node)
            if name in self.env:
                val = self.env[name]
                if isinstance(val, bool) or not isinstance(
                        val, numbers.Real):  # np.float32/int64 included
                    self._fail(D_UNSUPPORTED_EXPR,
                               f"{name!r} is bound to non-numeric "
                               f"capture-time value {val!r}", node)
                return Const(float(val))
            self._fail(D_UNKNOWN_NAME,
                       f"unknown name {name!r}: not a parameter, loop "
                       f"variable, const, or global", node)
        if isinstance(node, ast.Subscript):
            return self._ref(node)
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                self._fail(D_UNSUPPORTED_EXPR,
                           f"operator {type(node.op).__name__} is outside "
                           f"the IR's op set (+, -, *, /, calls)", node)
            return Node(op, (self._expr(node.left), self._expr(node.right)))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.UAdd):
                return self._expr(node.operand)
            if isinstance(node.op, ast.USub):
                kid = self._expr(node.operand)
                if isinstance(kid, Const):
                    return Const(-kid.val)
                return Node("neg", (kid,))
            self._fail(D_UNSUPPORTED_EXPR,
                       f"unary {type(node.op).__name__} is not capturable",
                       node)
        if isinstance(node, ast.Call):
            name = self._call_name(node.func)
            if name not in KNOWN_CALLS:
                self._fail(D_UNKNOWN_CALL,
                           f"call to {name!r} is not in the executable "
                           f"function set {KNOWN_CALLS}", node)
            # the name alone is not enough: `filters.sin` may be a custom
            # callable; when the callee resolves at capture time it must be
            # a recognized math/numpy/torch implementation
            try:
                resolved = const_eval(node.func, self.env)
            except Reject:
                resolved = None  # unresolvable (e.g. bare name): by-name
            if resolved is not None and not _is_known_impl(name, resolved):
                self._fail(D_UNKNOWN_CALL,
                           f"{name!r} resolves to a custom callable "
                           f"{resolved!r}, not the math/numpy elementwise "
                           f"function the IR executes", node)
            if len(node.args) != 1 or node.keywords:
                self._fail(D_UNKNOWN_CALL,
                           f"{name}() must take exactly one positional "
                           f"argument", node)
            return Node("call", (FuncName(name), self._expr(node.args[0])))
        if isinstance(node, ast.IfExp):
            self._fail(D_CONTROL_FLOW,
                       "conditional expression in the loop body", node)
        self._fail(D_UNSUPPORTED_EXPR,
                   f"uncapturable expression ({type(node).__name__})", node)


def capture(fn: Callable, shapes: Mapping[str, tuple],
            consts: Optional[Mapping] = None) -> Program:
    """Capture a plain-Python loop nest as a :class:`Program`.

    ``shapes`` maps every function parameter to ``()`` (scalar input) or an
    array shape tuple; ``consts`` supplies capture-time integer/float values
    for parameters or free names.  Raises :class:`CaptureError` (with a
    structured :class:`FrontendDiagnostic`) for anything outside the
    capturable scope, or ``ValueError`` for API misuse (missing shapes,
    sourceless functions).
    """
    from .. import obs

    fn = getattr(fn, "fn", fn)  # unwrap a RaceKernel
    try:
        with obs.span("capture", function=getattr(fn, "__name__", "?")):
            prog = _Capturer(fn, shapes, consts).run()
    except CaptureError as e:
        # every rejection is a pipeline decision: the stable diagnostic
        # code (13-code vocabulary) becomes a counter + structured event
        if obs.enabled():
            d = e.diagnostic
            obs.counter("race_frontend_diagnostics_total",
                        code=d.code).inc()
            obs.event("frontend_diagnostic", code=d.code,
                      message=d.message, line=d.line, col=d.col,
                      file=d.file, function=d.function)
        raise
    if obs.enabled():
        obs.counter("race_frontend_captures_total").inc()
    return prog
