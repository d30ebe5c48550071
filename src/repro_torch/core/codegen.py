"""Whole-array PyTorch evaluator for RACE plans: the ``"torch"`` backend.

Port of ``repro/core/codegen.py`` and ``repro/kernels/ref.py``.  Each
statement is evaluated as a whole-array expression over its iteration box:

  * ``A[a*i+b, ...]`` over ``i in [lo, hi]`` with distinct levels and
    ``a >= 0``  ->  a basic slice with a positive step (a view, no copy);
  * repeated levels, constant dims and negative coefficients  ->  advanced
    indexing with broadcast index tensors;
  * an auxiliary array  ->  one materialized tensor per aux, in topological
    order.  Eager torch materializes every intermediate, so the reference's
    ``optimization_barrier`` (which stops XLA fusion from recomputing an aux
    in every consumer) has no counterpart here.

Evaluators are plain functions over ``{name: tensor}``; they run on whatever
device the tensors lie on, and never write into the caller's tensors.  This
backend is also the independent yardstick the Hopper kernel is held against
on the card.

Scope note (paper §4.1): programs must not read an array they write except
pointwise at identical subscripts; the whole-array semantics relies on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import torch

from .depgraph import Plan
from .ir import Const, Expr, FuncName, Program, Ref, Stmt, expr_refs

FUNCS = {
    "sin": torch.sin,
    "cos": torch.cos,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "tanh": torch.tanh,
    "abs": torch.abs,
}


@dataclass
class _Buf:
    """Tensor plus the absolute index of its [0, 0, ...] corner per dim."""

    data: torch.Tensor
    lo: tuple


def _as_int(f) -> int:
    f = Fraction(f)
    if f.denominator != 1:
        raise ValueError(f"non-integral subscript offset {f}")
    return int(f)


def _eval_ref(ref: Ref, bufs: dict, domain_levels: tuple, ranges: dict):
    """Evaluate a reference over the domain box; the result broadcasts against
    tensors shaped (extent(l) for l in domain_levels)."""
    buf = bufs[ref.name]
    if not ref.subs:  # scalar
        return buf.data if isinstance(buf, _Buf) else buf
    data, base_lo = ((buf.data, buf.lo) if isinstance(buf, _Buf)
                     else (buf, (0,) * buf.dim()))

    dims_levels = [s.s for s in ref.subs]
    var_levels = [l for l in dims_levels if l != 0]
    if len(set(var_levels)) == len(var_levels) and all(
            s.a >= 0 for s in ref.subs):
        # positive-step slice per dim, then drop constant dims, order the
        # axes by level and insert singleton axes for unreferenced levels
        index = []
        for d, s in enumerate(ref.subs):
            if s.s == 0:
                index.append(_as_int(s.b) - base_lo[d])
            else:
                lo, hi = ranges[s.s]
                start = s.a * lo + _as_int(s.b) - base_lo[d]
                stop = s.a * hi + _as_int(s.b) - base_lo[d] + 1
                index.append(slice(start, stop, max(s.a, 1)))
        sl = data[tuple(index)]
        perm = sorted(range(len(var_levels)), key=lambda k: var_levels[k])
        sl = sl.permute(perm)
        shape = [1] * len(domain_levels)
        for ax, lvl in enumerate(sorted(var_levels)):
            shape[domain_levels.index(lvl)] = sl.shape[ax]
        return sl.reshape(shape)

    # advanced indexing (repeated levels / negative coefficients)
    idxs = []
    for d, s in enumerate(ref.subs):
        if s.s == 0:
            idxs.append(torch.tensor(_as_int(s.b) - base_lo[d],
                                     device=data.device))
        else:
            lo, hi = ranges[s.s]
            vec = (s.a * torch.arange(lo, hi + 1, device=data.device)
                   + _as_int(s.b) - base_lo[d])
            shape = [1] * len(domain_levels)
            shape[domain_levels.index(s.s)] = hi - lo + 1
            idxs.append(vec.reshape(shape))
    return data[tuple(idxs)]


def _eval_expr(e: Expr, bufs: dict, domain_levels: tuple, ranges: dict,
               memo: dict):
    def ev(x: Expr):
        if isinstance(x, Ref):
            # the same Ref often occurs many times in one statement (that is
            # the reuse RACE detects); slice it once per statement
            val = memo.get(x)
            if val is None:
                val = memo[x] = _eval_ref(x, bufs, domain_levels, ranges)
            return val
        if isinstance(x, Const):
            return x.val
        if isinstance(x, FuncName):  # only under 'call'
            raise ValueError("bare function name")
        if x.op == "call":
            f, arg = FUNCS[x.kids[0].name], ev(x.kids[1])
            if isinstance(arg, torch.Tensor):
                return f(arg)
            # a constant argument: at float64, as the reference's jnp.<f>
            # of a Python float under x64 (and nan where jnp gives nan,
            # which math.log(-1.0) would not); the Python float it gives
            # back is a weak scalar to torch, as to jnp, so it never
            # changes the dtype of the array it meets
            return f(torch.tensor(arg, dtype=torch.float64)).item()
        if x.op == "neg":
            return -ev(x.kids[0])
        if x.op == "inv":
            return 1.0 / ev(x.kids[0])
        a, b = ev(x.kids[0]), ev(x.kids[1])
        if x.op == "+":
            return a + b
        if x.op == "-":
            return a - b
        if x.op == "*":
            return a * b
        if x.op == "/":
            return a / b
        raise ValueError(f"bad op {x.op}")

    try:
        return ev(e)
    finally:
        # ev refers to itself through its cell: without this the cycle
        # keeps memo's slices, and the buffers they view, until gc runs
        del ev


def _box(domain_levels: tuple, ranges: dict) -> tuple:
    return tuple(ranges[l][1] - ranges[l][0] + 1 for l in domain_levels)


def _const_canvas(env: dict) -> tuple:
    """``(dtype, device)`` of a statement's value that holds no array
    (``o[i] = 0.1``): float64 when the env holds a float64 tensor, else
    float32, on the env's device.  Those are the dtypes the reference's
    Python-float value takes under x64 and in its default mode.  A half
    env gives float32 too, as the reference's default mode does (the mode
    its half-precision runs take): the constant is not rounded to half
    before anything reads it."""
    dtype, device = torch.float32, None
    for v in env.values():
        if isinstance(v, torch.Tensor):
            device = v.device if device is None else device
            if v.dtype == torch.float64:
                dtype = torch.float64
    return dtype, device


def _write_stmt(st: Stmt, value, out: dict, env: dict, ranges: dict,
                domain_levels: tuple) -> None:
    """Scatter the computed box into the lhs array region.

    The caller's tensors are never written: an output that already exists in
    ``env`` is cloned first, and later statements write into that clone."""
    lhs_levels = [s.s for s in st.lhs.subs]
    perm = [domain_levels.index(l) for l in lhs_levels]
    name = st.lhs.name
    region = []
    for s in st.lhs.subs:
        lo, hi = ranges[s.s]
        region.append(slice(s.a * lo + _as_int(s.b), s.a * hi + _as_int(s.b) + 1))
    if name in out:
        base = out[name]
    elif name in env:
        base = torch.as_tensor(env[name]).clone()
    else:
        base = None
    if not isinstance(value, torch.Tensor):  # a constant right-hand side
        dtype, device = (_const_canvas(env) if base is None
                         else (base.dtype, base.device))
        value = torch.tensor(value, dtype=dtype, device=device)
    value = value.expand(_box(domain_levels, ranges)).permute(perm)
    if base is None:  # new_zeros: under vmap a batched value makes a
        # batched canvas
        base = value.new_zeros(tuple(r.stop for r in region))
    base[tuple(region)] = value.to(base.dtype)
    out[name] = base


def build_plan_evaluator(plan: Plan):
    """Evaluator for the RACE-transformed program."""
    full = plan.program.ranges()
    all_levels = tuple(sorted(full))

    def run(env: dict) -> dict:
        bufs: dict = dict(env)
        for aux in plan.aux_order:
            rng = plan.ranges[aux.name]
            levels = tuple(sorted(aux.levels))
            val = _eval_expr(plan.aux_exprs[aux.name], bufs, levels, rng, {})
            if isinstance(val, torch.Tensor):
                val = val.expand(_box(levels, rng))
            # else a constant aux (its levels are those of no array: a
            # scalar), kept a Python float: a weak scalar to every reader,
            # as the reference's weakly typed constant is
            bufs[aux.name] = _Buf(val, tuple(rng[l][0] for l in levels))
        out: dict = {}
        for st in plan.body:
            # fresh memo per statement: bufs mutates between statements
            val = _eval_expr(st.rhs, bufs, all_levels, full, {})
            _write_stmt(st, val, out, env, full, all_levels)
            bufs[st.lhs.name] = out[st.lhs.name]
        return out

    return run


def build_batched_evaluator(plan: Plan):
    """The plan's evaluator over a leading batch dimension of every env
    entry (scalars as ``(B,)``), interior convention: ``torch.func.vmap``
    of the per-example evaluator, so ``out[name][b]`` is the per-example
    output of ``env[...][b]``."""
    run = build_plan_evaluator(plan)
    return torch.func.vmap(lambda env: interior(plan, run(env)))


def build_evaluator(plan: Plan, backend: str = "auto", *, device=None,
                    block_rows: int = 0, block_cols: int = 0,
                    block_inner: int = 0):
    """Backend-dispatching evaluator factory for a plan.

    Returns ``(run, selection)``: ``run(env)`` moves ``env`` to ``device``
    (``None``: cuda, as every entry point) and yields interior-convention
    outputs on the resolved backend; ``selection`` says which backend was
    chosen and, on an ``"auto"`` fallback, why the kernel was refused.
    Where the plan takes the kernel, ``run`` goes through the executor
    cache under the request (the kernel's wrapper, or its tile emulator on
    the CPU; ``"auto"`` still falls back on the env's dtypes); otherwise it
    is the plain evaluator."""
    from .backend import select_backend
    from .executor import compile_plan, env_to_torch, resolve_device

    sel = select_backend(plan, backend)
    plan_run = build_plan_evaluator(plan)

    def run(env: dict) -> dict:
        env = env_to_torch(env, resolve_device(device))
        if sel.backend == "hopper":
            return compile_plan(plan, env, backend, block_rows=block_rows,
                                block_cols=block_cols,
                                block_inner=block_inner)(env)
        return interior(plan, plan_run(env))

    return run, sel


def build_baseline_evaluator(program: Program):
    """Evaluator for the unmodified program (same machinery, no auxs)."""
    full = program.ranges()
    all_levels = tuple(sorted(full))

    def run(env: dict) -> dict:
        bufs: dict = dict(env)
        out: dict = {}
        for st in program.body:
            val = _eval_expr(st.rhs, bufs, all_levels, full, {})
            _write_stmt(st, val, out, env, full, all_levels)
            bufs[st.lhs.name] = out[st.lhs.name]
        return out

    return run


def interior(plan: Plan, full_outputs: dict) -> dict:
    """Slice evaluator outputs (full-array layout) down to the statement
    ranges, matching the kernel's return convention."""
    ranges = plan.program.ranges()
    out = {}
    for st in plan.body:
        sl = []
        for s in st.lhs.subs:
            lo, hi = ranges[s.s]
            sl.append(slice(lo + int(s.b), hi + int(s.b) + 1))
        out[st.lhs.name] = full_outputs[st.lhs.name][tuple(sl)]
    return out


def required_shapes(program: Program) -> dict:
    """Minimal array shapes covering every access (for building test data)."""
    full = program.ranges()
    shapes: dict = {}

    def see(ref: Ref):
        if not ref.subs:
            shapes.setdefault(ref.name, ())
            return
        dims = []
        for s in ref.subs:
            if s.s == 0:
                dims.append(_as_int(s.b) + 1)
            else:
                lo, hi = full[s.s]
                dims.append(max(s.a * lo + _as_int(s.b),
                                s.a * hi + _as_int(s.b)) + 1)
        cur = shapes.get(ref.name)
        shapes[ref.name] = tuple(
            max(a, b) for a, b in zip(cur, dims)) if cur else tuple(dims)

    for st in program.body:
        see(st.lhs)
        for r in expr_refs(st.rhs):
            see(r)
    return shapes
