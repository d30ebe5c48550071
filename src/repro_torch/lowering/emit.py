"""The RACE stencil kernel for Hopper: tile program, CUDA C++, CPU emulator.

Replaces the TPU kernel ``repro/lowering/emit.py:build_kernel`` (built by
``specialize_stencil``, laid out by ``repro/lowering/blocks.py:build_layout``,
with the in-kernel gather ``repro/lowering/gather.py:gather_ref``).  As in
Pallas, a kernel is generated for each plan, in two layers:

  * :func:`tile_program` turns ``(plan, analysis, launch geometry)`` into a
    :class:`TileProgram`: the launch geometry with the march's schedule
    (:mod:`.blocks`: rings, their depths, leads and first steps, and the
    ring slot and offset of every shifted read), each base reference as an
    affine index ``a·i + b`` per dimension of the array's own layout, the
    scalars and rank-0 aux, the outputs in their own dimension order, and
    the expression trees;
  * :func:`render_cuda` renders it as one ``__global__`` function, templated
    on ``scalar_t`` and instantiated for ``float`` and ``double``, plus an
    ``extern "C"`` launcher (built by :mod:`repro_torch.kernels.build`);
    :func:`emulate` runs the same march with torch on the CPU — same rings,
    slots, warm-up, segment ends, staged planes and guarded loads — as the
    kernel's plain version.

What bounds it on the H100: device-memory bytes.  A stencil does a few
operations per element it reads, far below the card's balance, so the least
time is the bytes of the inputs read once and the outputs written once over
3.35 TB/s.  float64 runs at a fraction of float32's arithmetic rate on this
card, but the kernel stays bound by memory, so the design is the same for
both.  What the design does about the bytes (a 2.5-D streaming kernel):

  * a block owns a tile of the plane of every level but the stream level
    and marches along a segment of it, one plane per step.  Each aux that
    covers the stream level is a ring of planes in shared memory over its
    exact one-sided range; each step evaluates every aux's leading plane
    once, then one output plane.  No aux array is ever written to device
    memory, and no aux value is recomputed in another plane's halo beyond
    the plane tile's own — RACE's reuse is realised as shared-memory hits;
  * operands read at unit positive coefficients are staged one plane
    window per step with ``cp.async`` (zero-filled outside the array),
    one step ahead (double buffering); the rest (strided, mirrored,
    gathered) are read in place through their affine indices with guarded
    64-bit loads.
    Outputs are written straight into their own dimension order.  The
    per-call transposes, flips, pads and ``3**k`` halo copies the Pallas
    path made to feed BlockSpec do not exist here;
  * rank-0 aux (loop-invariant; the reference's ``scalar-aux``) are
    evaluated once per thread into registers at the top of the kernel;
  * in-plane offsets are 32-bit where they fit, plane bases 64-bit, and
    each ring's slot base rotates once per step;
  * a batch (``run_batch``; the reference's ``jax.vmap`` over
    ``pallas_call``) is the grid's second axis: ``blockIdx.y`` is the
    example, each pointer moves by its per-example count, and the rank-0
    aux, evaluated from that example's scalars, are per example.  The
    schedule is the per-example one at every batch size;
  * constants are emitted at full double precision as ``scalar_t(<repr>)``
    (the reference Pallas kernel rounds every constant to float32).

nvcc contracts ``a*b + c`` into FMA by default, which rounds differently
from torch's eager ops; the differences sit far inside the ``plan``
tolerance (float32 1e-5, float64 1e-12), so no flag disables it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from math import isfinite, prod
from typing import Mapping

import torch

from ..core.depgraph import Plan
from ..core.ir import Const, Expr, Node, Ref, expr_refs
from .blocks import BODY, LaunchGeometry, build_geometry
from .facts import R_HOPPER_DTYPE, FallbackReason, LoweringError
from .geometry import kernel_analysis

#: operand dtypes the kernel is instantiated for, with their byte widths;
#: the launcher's dtype code is the position in this table
KERNEL_DTYPES = {"float32": 4, "float64": 8}

#: examples one launch takes: CUDA's limit on ``gridDim.y``
MAX_GRID_Y = 65535
_FUNCS = ("sin", "cos", "exp", "log", "sqrt", "tanh", "abs")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dtype_reasons(dtypes) -> list:
    """``hopper-dtype`` reasons for a set of operand dtype names."""
    names = sorted(set(dtypes))
    bad = [d for d in names if d not in KERNEL_DTYPES]
    if bad:
        return [FallbackReason(
            R_HOPPER_DTYPE,
            f"operand dtype {', '.join(bad)} is not one the kernel takes "
            f"({', '.join(KERNEL_DTYPES)})")]
    if len(names) > 1:
        return [FallbackReason(
            R_HOPPER_DTYPE,
            f"operands mix dtypes {', '.join(names)}; the kernel takes one")]
    return []


# ---------------------------------------------------------------------------
# the tile program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Operand:
    """One base array, read in place in its own (contiguous) layout."""

    name: str
    shape: tuple
    strides: tuple  # element strides of the contiguous layout
    dims: tuple  # loop level of each array dimension (0: constant)
    ring: int = -1  # its staged ring in the geometry; -1: device memory


@dataclass(frozen=True)
class Output:
    """One body statement's interior output, in its own dimension order.

    The kernel computes it at the operand dtype; ``dtype`` is the dtype the
    wrapper returns: the env's output array's where the env carries one (as
    the ``"torch"`` backend, which writes into a copy of that array), else
    the operand dtype."""

    name: str
    levels: tuple  # loop level of each output dimension
    shape: tuple
    dtype: str


@dataclass(frozen=True)
class TileProgram:
    """Everything the CUDA rendering and the CPU emulator share.  The
    schedule (rings, their depths, leads and first steps, and the ring slot
    and offset of every shifted read) is ``geometry.rings`` and
    ``geometry.reads``."""

    geometry: LaunchGeometry
    dtype: str  # "float32" | "float64"
    operands: tuple  # Operand, sorted by name
    scalars: tuple  # env scalar names, sorted
    scalar_aux: tuple  # (name, Expr) of the rank-0 aux, topological
    outputs: tuple  # Output, one per body statement
    aux_exprs: tuple  # Expr per aux ring (the first rings of the geometry)
    body: tuple  # Expr per output

    @property
    def aux(self) -> tuple:
        return self.geometry.rings[:len(self.aux_exprs)]

    @property
    def smem_elems(self) -> int:
        return self.geometry.smem_elems

    @property
    def smem_bytes(self) -> int:
        return self.smem_elems * KERNEL_DTYPES[self.dtype]

    @property
    def example_elems(self) -> tuple:
        """``(operand elements, output elements, scalars)`` of one example:
        the strides of the batch axis (each operand's and output's pointer
        moves by its count per example, the scalars' by theirs)."""
        return (tuple(prod(o.shape) for o in self.operands),
                tuple(prod(o.shape) for o in self.outputs), len(self.scalars))

    @property
    def aux_evals_per_point(self) -> float:
        """Aux values a block evaluates per output point it owns (the
        floor is one per aux): each ring's plane once per step from its
        first step, each box once."""
        g = self.geometry
        evals = sum(r.plane * (g.seg - r.start if r.streamed else 1)
                    for r in self.aux)
        return evals / (g.plane_points * g.seg)


def affine(ref: Ref) -> tuple:
    """``((a, level, b), ...)`` per array dimension (level 0: constant b)."""
    return tuple((s.a, s.s, int(s.b)) for s in ref.subs)


def _contiguous_strides(shape: tuple) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def tile_program(plan: Plan, shapes: Mapping, dtypes: Mapping,
                 block_rows: int = 0, block_cols: int = 0,
                 block_inner: int = 0) -> TileProgram:
    """Specialize a plan for one environment signature.

    ``shapes`` maps env names to shapes (``()`` for scalars) and ``dtypes``
    to dtype names.  Raises :class:`LoweringError` with the probe's structured
    reasons when the plan, its dtypes or its aux footprint are out of reach.
    """
    analysis = kernel_analysis(plan)
    if not analysis.eligible:
        raise LoweringError(analysis.reasons)
    names = tuple(sorted(analysis.arrays))
    missing = [nm for nm in names if nm not in shapes]
    if missing:
        raise ValueError(f"environment is missing base arrays {missing}")
    reasons = dtype_reasons(str(dtypes[nm]) for nm in names)
    if reasons:
        raise LoweringError(reasons)
    dtype = str(dtypes[names[0]])
    geo = build_geometry(plan, KERNEL_DTYPES[dtype], block_rows, block_cols,
                         block_inner)
    staged = {r.name: k for k, r in enumerate(geo.rings) if r.operand}
    operands = []
    for nm in names:
        shape = tuple(shapes[nm])
        if len(shape) != analysis.arrays[nm].ndim:
            raise ValueError(
                f"{nm}: environment array has rank {len(shape)}, plan "
                f"references rank {analysis.arrays[nm].ndim}")
        operands.append(Operand(nm, shape, _contiguous_strides(shape),
                                analysis.arrays[nm].dims,
                                staged.get(nm, -1)))

    scalar_aux = tuple((a.name, plan.aux_exprs[a.name])
                       for a in plan.aux_order if not a.levels)
    aux_exprs = tuple(plan.aux_exprs[a.name]
                      for a in plan.aux_order if a.levels)
    body = tuple(st.rhs for st in plan.body)
    rank0 = {nm for nm, _ in scalar_aux}
    scalars = tuple(sorted(
        {r.name for e in aux_exprs + body + tuple(e for _, e in scalar_aux)
         for r in expr_refs(e) if not r.subs} - rank0))
    outputs = []
    for st in plan.body:
        levels = tuple(s.s for s in st.lhs.subs)
        outputs.append(Output(st.lhs.name, levels,
                              tuple(geo.extents[l - 1] for l in levels),
                              str(dtypes.get(st.lhs.name, dtype))))
    return TileProgram(geometry=geo, dtype=dtype, operands=tuple(operands),
                       scalars=scalars, scalar_aux=scalar_aux,
                       outputs=tuple(outputs), aux_exprs=aux_exprs,
                       body=body)


# ---------------------------------------------------------------------------
# CUDA C++ rendering
# ---------------------------------------------------------------------------


def _fits32(shape: tuple, strides: tuple, dims) -> bool:
    """Whether offsets over array dimensions ``dims`` fit a 32-bit int."""
    return sum((shape[d] - 1) * strides[d] for d in dims) < 2 ** 31


def _offset(terms: list, small: bool) -> str:
    """Sum of ``(index, stride)`` terms, in 32 bits when ``small``."""
    cast = "" if small else "(long long)"
    return " + ".join(f"{cast}({ix}) * {st}" for ix, st in terms) or "0"


class _Box:
    """Code for one box of a step (an aux plane, an aux box evaluated once
    per block, or the output plane) or, with ``key=None``, for the rank-0
    aux at the top of the kernel."""

    def __init__(self, tp: TileProgram, key):
        g = tp.geometry
        self.tp, self.key = tp, key
        if key == BODY:
            self.levels = tuple(range(1, g.m + 1))
            self.lo, self.lead = (0,) * g.m, 0
            self.widths = tuple(g.tile[l - 1] if l in g.order else 1
                                for l in range(1, g.m + 1))
            self.streamed = bool(g.s_level)
        elif key is not None:
            r = g.rings[key]
            self.levels, self.lo, self.lead = r.levels, r.lo, r.lead
            self.widths, self.streamed = r.widths, r.streamed
        self.rank0 = [nm for nm, _ in tp.scalar_aux]
        self.loads: dict = {}  # base Ref -> local variable name
        self.lines: list = []

    def header(self) -> list:
        """Loop header: a thread-strided sweep of the box, fastest level
        first, with each covered level's index ``i<l>``."""
        g = self.tp.geometry
        plane = [l for l in g.order if l in self.levels]
        size = prod(self.widths[l - 1] for l in plane)
        lines = [f"    for (int e = threadIdx.x; e < {size}; "
                 f"e += {g.threads}) {{", "      int q = e;"]
        for k, l in enumerate(plane):
            if k == len(plane) - 1:
                lines.append(f"      const int p{l} = q;")
            else:
                lines.append(f"      const int p{l} = q % "
                             f"{self.widths[l - 1]}; q /= "
                             f"{self.widths[l - 1]};")
            lines.append(f"      const int i{l} = t{l} + ({self.lo[l - 1]} "
                         f"+ p{l});")
        if self.streamed:
            lines.append(f"      const int i{g.s_level} = z + {self.lead};")
        lines.append("      (void)q;")
        return lines

    def expr(self, e: Expr) -> str:
        tp = self.tp
        if isinstance(e, Const):
            if not isfinite(e.val):
                raise ValueError(f"constant {e.val!r} has no C++ literal")
            return f"scalar_t({float(e.val)!r})"
        if isinstance(e, Ref):
            if not e.subs:
                if e.name in self.rank0:
                    return f"ra{self.rank0.index(e.name)}"
                return f"sc{tp.scalars.index(e.name)}"
            rd = tp.geometry.reads.get((self.key, e))
            if rd is not None:
                return self._read(rd)
            return self._load(e)
        if isinstance(e, Node):
            if e.op == "call":
                if e.kids[0].name not in _FUNCS:
                    raise ValueError(f"no device function {e.kids[0].name}")
                return f"race_{e.kids[0].name}({self.expr(e.kids[1])})"
            if e.op == "neg":
                return f"(-{self.expr(e.kids[0])})"
            if e.op == "inv":
                return f"(scalar_t(1) / {self.expr(e.kids[0])})"
            return (f"({self.expr(e.kids[0])} {e.op} "
                    f"{self.expr(e.kids[1])})")
        raise TypeError(e)

    def _read(self, rd) -> str:
        g = self.tp.geometry
        r = g.rings[rd.ring]
        base = f"b{rd.ring}_{rd.back}" if r.streamed else str(r.offset)
        terms = [f"(p{l} + {rd.offset[l - 1]}) * {r.strides[l - 1]}"
                 for l in g.order if l in r.levels]
        return f"smem[{base} + " + (" + ".join(terms) or "0") + "]"

    def _load(self, ref: Ref) -> str:
        """A guarded read from device memory (outside the array reads 0),
        in 64-bit index arithmetic."""
        var = self.loads.get(ref)
        if var is not None:
            return var
        var = self.loads[ref] = f"v{len(self.loads)}"
        k = next(i for i, o in enumerate(self.tp.operands)
                 if o.name == ref.name)
        op = self.tp.operands[k]
        idx, guard, off = [], [], []
        for d, (a, s, b) in enumerate(affine(ref)):
            dv = f"{var}_{d}"
            rhs = f"{b}LL" if s == 0 else f"{a}LL * i{s} + ({b}LL)"
            idx.append(f"        const long long {dv} = {rhs};")
            guard.append(f"{dv} >= 0 && {dv} < {op.shape[d]}LL")
            off.append(f"{dv} * {op.strides[d]}LL")
        self.lines.append(f"      scalar_t {var} = scalar_t(0);")
        self.lines.append("      {")
        self.lines.extend(idx)
        self.lines.append(f"        if ({' && '.join(guard) or 'true'}) "
                          f"{var} = in{k}[{' + '.join(off) or '0'}];")
        self.lines.append("      }")
        return var


def _stage(tp: TileProgram, k: int, step: str, slot: str) -> list:
    """Copy one operand plane window into its ring slot with ``cp.async``
    (reads 0 outside the array): the plane of step ``step``.  Threads run
    the operand's own contiguous level fastest, so that a warp's loads
    coalesce whatever the ring's element order."""
    g = tp.geometry
    r = g.rings[k]
    ix = next(i for i, o in enumerate(tp.operands) if o.ring == k)
    op = tp.operands[ix]
    ds = op.dims.index(g.s_level)
    plane = [l for l in reversed(op.dims) if l in g.order]
    inner = [d for d in range(len(op.dims)) if d != ds]
    lines = [
        "    {",
        f"      const int zz = z0 + ({step}) + {r.lead};",
        f"      const bool zok = zz >= 0 && zz < {op.shape[ds]};",
        f"      const scalar_t* const src = zok ? in{ix} + (long long)zz * "
        f"{op.strides[ds]}LL : in{ix};",
        f"      scalar_t* const dst = smem + {r.offset} + ({slot}) * "
        f"{r.plane};",
        f"      for (int e = threadIdx.x; e < {r.plane}; "
        f"e += {g.threads}) {{",
        "        int q = e;",
    ]
    for n, l in enumerate(plane):
        if n == len(plane) - 1:
            lines.append(f"        const int p{l} = q;")
        else:
            lines.append(f"        const int p{l} = q % {r.widths[l - 1]}; "
                         f"q /= {r.widths[l - 1]};")
        lines.append(f"        const int j{l} = t{l} + ({r.lo[l - 1]} + "
                     f"p{l});")
    guard = ["zok"] + [f"j{op.dims[d]} >= 0 && j{op.dims[d]} < {op.shape[d]}"
                       for d in inner]
    off = _offset([(f"j{op.dims[d]}", op.strides[d]) for d in inner],
                  _fits32(op.shape, op.strides, inner))
    pos = _offset([(f"p{l}", r.strides[l - 1]) for l in plane], True)
    lines += [
        "        (void)q;",
        f"        const bool ok = {' && '.join(guard)};",
        f"        race_cp_async(dst + {pos}, ok ? src + {off} : in{ix}, ok);",
        "      }",
        "    }",
    ]
    return lines


def render_cuda(tp: TileProgram) -> str:
    """CUDA C++ source of the plan's kernel and its ``extern "C"`` launcher.

    The launcher is ``int race_stencil_launch(int dtype, const void* const*
    ins, void* const* outs, const void* scalars, int batch, void* stream)``:
    dtype is 0 for float and 1 for double; it returns
    ``cudaGetLastError()``.  The grid is ``(tiles, batch)``: ``blockIdx.y``
    is the example, and every operand, output and scalar pointer moves by
    its per-example count (:attr:`TileProgram.example_elems`, constants of
    the signature) times ``blockIdx.y``, in 64 bits.  A single run passes
    ``batch`` 1, so one source serves every batch size."""
    g = tp.geometry
    m, s = g.m, g.s_level
    n_in, n_out = len(tp.operands), len(tp.outputs)
    n_aux = len(tp.aux_exprs)
    staged = [k for k, r in enumerate(g.rings) if r.operand]
    streamed = [k for k, r in enumerate(g.rings) if r.streamed]
    lines = [
        "// Generated by repro_torch.lowering.emit.render_cuda: the RACE "
        "stencil kernel",
        f"// of one plan, depth {m}, block {g.tile}, stream level {s}, "
        f"{n_aux} aux and {len(staged)} staged operands in shared memory.",
        '#include "race_stencil.cuh"',
        "",
        "namespace {",
        "",
        "template <typename scalar_t>",
        f"__global__ void __launch_bounds__({g.threads}) race_stencil_kernel(",
        f"    const RaceArgs<scalar_t, {n_in}, {n_out}> args) {{",
    ]
    if g.rings:
        lines += [
            "  extern __shared__ __align__(16) unsigned char race_smem[];",
            "  scalar_t* const smem = reinterpret_cast<scalar_t*>(race_smem);",
        ]
    in_elems, out_elems, n_sc = tp.example_elems
    lines.append("  const long long bz = blockIdx.y;  // the example")
    for k in range(n_in):
        lines.append(f"  const scalar_t* const __restrict__ in{k} = "
                     f"args.in[{k}] + bz * {in_elems[k]}LL;")
    for k in range(n_out):
        lines.append(f"  scalar_t* const __restrict__ out{k} = args.out[{k}] "
                     f"+ bz * {out_elems[k]}LL;")
    for k in range(n_sc):
        lines.append(f"  const scalar_t sc{k} = args.scalars[bz * {n_sc}LL + "
                     f"{k}];")
    for k, (nm, e) in enumerate(tp.scalar_aux):
        lines.append(f"  const scalar_t ra{k} = {_Box(tp, None).expr(e)};  "
                     f"// {nm}")
    lines.append("  int bid = blockIdx.x;")
    for l in g.order:
        lines.append(f"  const int t{l} = {g.lo[l - 1]} + (bid % "
                     f"{g.nb[l - 1]}) * {g.tile[l - 1]}; bid /= "
                     f"{g.nb[l - 1]};")
    lines.append(f"  const int z0 = {g.lo[s - 1] if s else 0} + bid * "
                 f"{g.seg};")
    lines.append("  (void)bid; (void)z0; (void)bz;")

    def evaluate(key: int, dst: str) -> list:
        box = _Box(tp, key)
        val = box.expr(tp.aux_exprs[key])
        return box.header() + box.lines + [f"      {dst} = {val};", "    }"]

    for k in range(n_aux):
        if not g.rings[k].streamed:
            r = g.rings[k]
            lines.append(f"  // aux {r.name}: one box, levels {r.levels}, "
                         f"[{r.lo}, {r.hi}]")
            lines += ["  {"] + evaluate(k, f"smem[{r.offset} + e]") + [
                "  }", "  __syncthreads();"]

    lines.append(f"  // the march: steps {g.k0}..{g.seg - 1}, output plane "
                 f"z0 + k from step 0")
    for k in streamed:
        lines.append(f"  int r{k} = 0;  // ring {g.rings[k].name}: slot of "
                     f"its lead, (k - {g.k0}) mod {g.rings[k].depth}")
    if staged:  # the planes of the first step
        for k in staged:
            if g.rings[k].start <= g.k0:
                lines += _stage(tp, k, str(g.k0), "0")
        lines.append("  race_cp_async_commit();")
    lines.append(f"  for (int k = {g.k0}; k < {g.seg}; ++k) {{")
    if staged:  # this step's planes have landed
        lines.append("    race_cp_async_wait<0>();")
    lines.append("    __syncthreads();")
    if s:
        lines.append("    const int z = z0 + k;")
    for ring, back in sorted({(rd.ring, rd.back) for rd in g.reads.values()
                              if g.rings[rd.ring].streamed}):
        r = g.rings[ring]
        slot = (f"r{ring}" if back == 0 else
                f"(r{ring} >= {back} ? r{ring} - {back} : r{ring} + "
                f"{r.depth - back})")
        lines.append(f"    const int b{ring}_{back} = {r.offset} + {slot} * "
                     f"{r.plane};")
    if staged:  # the planes of the next step, into the slot after the lead
        lines.append(f"    if (k + 1 < {g.seg}) {{")
        for k in staged:
            r = g.rings[k]
            if r.start > g.k0 + 1:
                lines.append(f"    if (k + 1 >= {r.start})")
            lines += _stage(tp, k, "k + 1",
                            f"(r{k} + 1 == {r.depth} ? 0 : r{k} + 1)")
        lines += ["    }", "    race_cp_async_commit();"]
    phases = sorted({g.rings[k].phase for k in range(n_aux)
                     if g.rings[k].streamed})
    for ph in phases:
        for k in range(n_aux):
            r = g.rings[k]
            if not r.streamed or r.phase != ph:
                continue
            lines.append(f"    // aux {r.name}: levels {r.levels}, [{r.lo}, "
                         f"{r.hi}], ring of {r.depth}, lead {r.lead}, "
                         f"phase {ph}")
            lines.append(f"    if (k >= {r.start}) {{" if r.start > g.k0
                         else "    {")
            lines += evaluate(k, f"smem[{r.offset} + r{k} * {r.plane} + e]")
            lines.append("    }")
        lines.append("    __syncthreads();")

    lines.append("    // body: one output plane")
    cond = f"k >= 0 && z <= {g.hi[s - 1]}" if s else "k >= 0"
    lines.append(f"    if ({cond}) {{")
    box = _Box(tp, BODY)
    lines += box.header()
    plane = [l for l in g.order]
    if plane:
        lines.append("      if (" + " || ".join(
            f"i{l} > {g.hi[l - 1]}" for l in plane) + ") continue;")
    vals = [box.expr(e) for e in tp.body]
    lines += box.lines
    for k, (out, val) in enumerate(zip(tp.outputs, vals)):
        strides = _contiguous_strides(out.shape)
        inner = [d for d, l in enumerate(out.levels) if l != s]
        off = _offset([(f"i{out.levels[d]} - {g.lo[out.levels[d] - 1]}",
                        strides[d]) for d in inner],
                      _fits32(out.shape, strides, inner))
        if s:
            ds = out.levels.index(s)
            off = (f"(long long)(z - {g.lo[s - 1]}) * {strides[ds]}LL + "
                   f"{off}")
        lines.append(f"      out{k}[{off}] = {val};")
    lines += ["    }", "    }"]
    for k in streamed:
        lines.append(f"    r{k} = r{k} + 1 == {g.rings[k].depth} ? 0 : "
                     f"r{k} + 1;")
    lines += ["  }", "}", ""]

    smem = f"{tp.smem_elems} * sizeof(scalar_t)"
    lines += [
        "template <typename scalar_t>",
        "int launch(const void* const* ins, void* const* outs, "
        "const void* scalars,",
        "           int batch, cudaStream_t stream) {",
        f"  RaceArgs<scalar_t, {n_in}, {n_out}> a;",
        f"  for (int k = 0; k < {n_in}; ++k) "
        "a.in[k] = static_cast<const scalar_t*>(ins[k]);",
        f"  for (int k = 0; k < {n_out}; ++k) "
        "a.out[k] = static_cast<scalar_t*>(outs[k]);",
        "  a.scalars = static_cast<const scalar_t*>(scalars);",
        f"  const size_t smem = {smem};",
        "  if (smem > 48 * 1024) {",
        "    const cudaError_t err = cudaFuncSetAttribute(",
        "        race_stencil_kernel<scalar_t>,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, "
        "static_cast<int>(smem));",
        "    if (err != cudaSuccess) return static_cast<int>(err);",
        "  }",
        f"  const dim3 grid({g.n_tiles}u, static_cast<unsigned>(batch));",
        f"  race_stencil_kernel<scalar_t><<<grid, {g.threads}, smem, "
        "stream>>>(a);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        "}  // namespace",
        "",
        'extern "C" int race_stencil_launch(int dtype, const void* const* '
        "ins,",
        "                                   void* const* outs, "
        "const void* scalars,",
        "                                   int batch, void* stream) {",
        "  const cudaStream_t s = static_cast<cudaStream_t>(stream);",
        "  if (batch < 1 || batch > 65535) "
        "return static_cast<int>(cudaErrorInvalidValue);",
        "  if (dtype == 0) return launch<float>(ins, outs, scalars, batch, "
        "s);",
        "  if (dtype == 1) return launch<double>(ins, outs, scalars, batch, "
        "s);",
        "  return static_cast<int>(cudaErrorInvalidValue);",
        "}",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CPU emulator: the kernel's plain version
# ---------------------------------------------------------------------------


def emulate(tp: TileProgram, env: Mapping) -> dict:
    """Run the tile program's march with torch, as the kernel does, every
    block at once (one leading axis per block).

    Values carry the block axis and one axis per loop level (size 1 where
    they do not vary).  Rank-0 aux, boxes, rings, their slots, the warm-up,
    segment ends, staged planes, guarded loads and guarded stores all follow
    :func:`render_cuda` and read the schedule from ``tp.geometry``."""
    g = tp.geometry
    m, s, B = g.m, g.s_level, g.n_tiles
    dt = _torch_dtype(tp.dtype)
    data = {o.name: env[o.name] for o in tp.operands}
    dev = data[tp.operands[0].name].device
    zero = torch.zeros((), dtype=dt, device=dev)
    scal = {nm: torch.as_tensor(env[nm]).to(device=dev, dtype=dt)
            for nm in tp.scalars}
    org, bid = {}, torch.arange(B, device=dev)
    for l in g.order + ((s,) if s else ()):
        org[l] = (g.lo[l - 1] + (bid % g.nb[l - 1]) * g.tile[l - 1]).reshape(
            [B] + [1] * m)
        bid = bid // g.nb[l - 1]

    def along(l: int, start: int, n: int):
        shape = [1] * (m + 1)
        shape[l] = n
        return (start + torch.arange(n, device=dev)).reshape(shape)

    def coords(levels, lo, widths, plane):
        """Index of each covered level over a box; ``plane`` on the stream
        level (None when the box is not on a plane)."""
        out = {l: org[l] + along(l, lo[l - 1], widths[l - 1])
               for l in g.order if l in levels}
        if plane is not None:
            out[s] = org[s] + plane
        return out

    def load(arr, idx_of):
        idx, ok = [], True
        for d, ix in enumerate(idx_of):
            if not torch.is_tensor(ix):
                ix = torch.tensor(ix, device=dev)
            ok = ok & (ix >= 0) & (ix < arr.shape[d])
            idx.append(ix.clamp(0, arr.shape[d] - 1))
        val = torch.where(ok, arr[tuple(idx)], zero)
        return val.reshape([1] * (m + 1)) if val.dim() == 0 else val

    rings = [torch.zeros([r.depth, B] + list(r.widths), dtype=dt,
                         device=dev) for r in g.rings]

    def evaluate(e: Expr, key, box: dict, k):
        memo: dict = {}

        def ev(x: Expr):
            if isinstance(x, Const):
                return torch.tensor(x.val, dtype=dt, device=dev)
            if isinstance(x, Ref):
                if not x.subs:
                    return scal[x.name]
                rd = g.reads.get((key, x))
                if rd is not None:
                    r = g.rings[rd.ring]
                    slot = (k - g.k0 - rd.back) % r.depth if r.streamed else 0
                    sl = [slice(None)] + [
                        slice(rd.offset[l - 1],
                              rd.offset[l - 1] + box["widths"][l - 1])
                        if l in r.levels and l != s else slice(0, 1)
                        for l in range(1, m + 1)]
                    return rings[rd.ring][slot][tuple(sl)]
                val = memo.get(x)
                if val is None:
                    c = box["coords"]
                    val = memo[x] = load(data[x.name], [
                        b if lv == 0 else a * c[lv] + b
                        for a, lv, b in affine(x)])
                return val
            if x.op == "call":
                return getattr(torch, x.kids[0].name)(ev(x.kids[1]))
            if x.op == "neg":
                return -ev(x.kids[0])
            if x.op == "inv":
                return 1.0 / ev(x.kids[0])
            a, b = ev(x.kids[0]), ev(x.kids[1])
            return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[x.op]

        return ev(e)

    def aux_box(k: int, step):
        r = g.rings[k]
        plane = step + r.lead if r.streamed else None
        return {"widths": r.widths,
                "coords": coords(r.levels, r.lo, r.widths, plane)}

    for nm, e in tp.scalar_aux:
        scal[nm] = evaluate(e, None, {}, None)
    n_aux = len(tp.aux_exprs)
    for k in range(n_aux):
        if not g.rings[k].streamed:
            rings[k][0] = evaluate(tp.aux_exprs[k], k, aux_box(k, None),
                                   None).expand([B] + list(g.rings[k].widths))

    body_widths = tuple(g.tile[l - 1] if l in g.order else 1
                        for l in range(1, m + 1))
    outs = [torch.zeros(o.shape, dtype=dt, device=dev) for o in tp.outputs]
    for step in range(g.k0, g.seg):
        for o in tp.operands:
            r = g.rings[o.ring] if o.ring >= 0 else None
            if r is None or step < r.start:
                continue
            c = coords(r.levels, r.lo, r.widths, step + r.lead)
            rings[o.ring][(step - g.k0) % r.depth] = load(
                data[o.name], [c[l] for l in o.dims]).expand(
                    [B] + list(r.widths))
        for k in sorted(range(n_aux), key=lambda k: g.rings[k].phase):
            r = g.rings[k]
            if r.streamed and step >= r.start:
                rings[k][(step - g.k0) % r.depth] = evaluate(
                    tp.aux_exprs[k], k, aux_box(k, step), step).expand(
                        [B] + list(r.widths))
        if step < 0:
            continue
        c = coords(range(1, m + 1), (0,) * m, body_widths,
                   step if s else None)
        keep = True
        for l, ix in c.items():
            keep = keep & (ix <= g.hi[l - 1])
        keep = keep.expand([B] + list(body_widths))
        box = {"widths": body_widths, "coords": c}
        for out, o, rhs in zip(outs, tp.outputs, tp.body):
            val = evaluate(rhs, BODY, box, step).expand(
                [B] + list(body_widths))
            strides = _contiguous_strides(o.shape)
            flat = sum((c[l] - g.lo[l - 1]) * st
                       for l, st in zip(o.levels, strides))
            flat = flat.expand([B] + list(body_widths))
            out.view(-1)[flat[keep]] = val[keep]
    return {o.name: out.to(_torch_dtype(o.dtype))
            for o, out in zip(tp.outputs, outs)}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


#: the C interface of a rendered source (see :func:`render_cuda`)
_SYMBOLS = {
    "race_stencil_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]),
    "race_stencil_error": (ctypes.c_char_p, [ctypes.c_int]),
}


def batch_chunks(batch: int) -> list:
    """``(first example, examples)`` of each launch of a batch: one launch
    per :data:`MAX_GRID_Y` examples."""
    if batch < 1:
        raise ValueError(f"a batch needs at least one example, got {batch}")
    return [(b, min(MAX_GRID_Y, batch - b))
            for b in range(0, batch, MAX_GRID_Y)]


def chunk_pointers(ptrs, elems, itemsize: int, first: int) -> list:
    """Base pointers of the launch whose first example is ``first``: each
    base moved by that many examples of its per-example element count."""
    return [p + first * n * itemsize for p, n in zip(ptrs, elems)]


class LoweredStencil:
    """One plan specialized for one environment signature: the kernel's
    wrapper.

    :meth:`apply` runs one example and :meth:`apply_batch` a batch whose
    every env entry carries a leading batch axis (scalars as ``(B,)``).
    Both run :func:`emulate` (per example) when the operands lie on the CPU,
    and launch the compiled kernel when they lie on a CUDA device — or
    raise: there is no fallback from the card to the emulator.  A batch is
    one launch per :data:`MAX_GRID_Y` examples.  ``launches`` counts this
    wrapper's kernel launches."""

    def __init__(self, tp: TileProgram):
        self.tp = tp
        self.source = render_cuda(tp)
        self.launches = 0
        self._lib = None

    def apply(self, env: Mapping) -> dict:
        ins = [env[o.name] for o in self.tp.operands]
        if all(t.device.type == "cpu" for t in ins):
            return emulate(self.tp, env)
        return self._launch(env, ins, None)

    __call__ = apply

    def apply_batch(self, env: Mapping) -> dict:
        tp = self.tp
        ins = [env[o.name] for o in tp.operands]
        batch = ins[0].shape[0]
        if all(t.device.type == "cpu" for t in ins):
            outs = [emulate(tp, {k: v[b] for k, v in env.items()})
                    for b in range(batch)]
            return {o.name: torch.stack([out[o.name] for out in outs])
                    for o in tp.outputs}
        return self._launch(env, ins, batch)

    def _launch(self, env: Mapping, ins: list, batch) -> dict:
        """Launch on the operands' card; ``batch`` None for one example."""
        tp = self.tp
        lead = () if batch is None else (batch,)
        dev = ins[0].device
        dt = _torch_dtype(tp.dtype)
        for o, t in zip(tp.operands, ins):
            if t.device != dev or dev.type != "cuda":
                raise ValueError(
                    f"{o.name} lies on {t.device}; the kernel takes operands "
                    f"on one CUDA device ({dev})")
            if t.dtype != dt:
                raise ValueError(f"{o.name} is {t.dtype}, the kernel was "
                                 f"specialized for {dt}")
            if tuple(t.shape) != lead + o.shape:
                raise ValueError(f"{o.name} has shape {tuple(t.shape)}, the "
                                 f"kernel was specialized for "
                                 f"{lead + o.shape}")
            if not t.is_contiguous():
                raise ValueError(f"{o.name} is not contiguous")
        for nm in tp.scalars:
            if tuple(env[nm].shape) != lead:
                raise ValueError(f"scalar {nm} has shape "
                                 f"{tuple(env[nm].shape)}, want {lead}")
        if self._lib is None:
            from ..kernels.build import load

            self._lib = load(self.source, _SYMBOLS)
        in_elems, out_elems, n_sc = tp.example_elems
        itemsize = KERNEL_DTYPES[tp.dtype]
        # the launcher's runtime calls act on the thread's current device
        with torch.cuda.device(dev):
            scal = None
            if n_sc:  # (B, n_scalars), or (n_scalars,) for one example
                scal = torch.stack([env[nm].to(device=dev, dtype=dt)
                                    for nm in tp.scalars], dim=-1)
            outs = [torch.empty(lead + o.shape, dtype=dt, device=dev)
                    for o in tp.outputs]
            in_base = [t.data_ptr() for t in ins]
            out_base = [t.data_ptr() for t in outs]
            stream = torch.cuda.current_stream(dev).cuda_stream
            for first, count in batch_chunks(batch or 1):
                in_ptrs = (ctypes.c_void_p * len(ins))(
                    *chunk_pointers(in_base, in_elems, itemsize, first))
                out_ptrs = (ctypes.c_void_p * len(outs))(
                    *chunk_pointers(out_base, out_elems, itemsize, first))
                sc_ptr = None if scal is None else chunk_pointers(
                    [scal.data_ptr()], [n_sc], itemsize, first)[0]
                rc = self._lib.race_stencil_launch(
                    list(KERNEL_DTYPES).index(tp.dtype), in_ptrs, out_ptrs,
                    sc_ptr, count, stream)
                if rc != 0:
                    msg = self._lib.race_stencil_error(rc).decode()
                    raise RuntimeError(f"race stencil kernel launch failed: "
                                       f"CUDA error {rc} ({msg})")
                self.launches += 1
        return {o.name: t.to(_torch_dtype(o.dtype))
                for o, t in zip(tp.outputs, outs)}


def specialize_stencil(plan: Plan, shapes: Mapping, dtypes: Mapping,
                       block_rows: int = 0, block_cols: int = 0,
                       block_inner: int = 0) -> LoweredStencil:
    """Build the kernel's wrapper for one environment signature (the CUDA
    source is rendered here and compiled at the first launch on a card)."""
    return LoweredStencil(tile_program(plan, shapes, dtypes, block_rows,
                                       block_cols, block_inner))
