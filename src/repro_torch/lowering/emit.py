"""The RACE stencil kernel for Hopper: tile program, CUDA C++, CPU emulator.

Replaces the TPU kernel ``repro/lowering/emit.py:build_kernel`` (built by
``specialize_stencil``, laid out by ``repro/lowering/blocks.py:build_layout``,
with the in-kernel gather ``repro/lowering/gather.py:gather_ref``).  As in
Pallas, a kernel is generated for each plan, in two layers:

  * :func:`tile_program` turns ``(plan, analysis, launch geometry)`` into a
    :class:`TileProgram`: the aux arrays in topological order, each with its
    levels, per-level extension ``ext`` and place in shared memory; each base
    reference as an affine index ``a·i + b`` per dimension of the array's own
    layout; the scalars; the outputs in their own dimension order; and the
    expression trees;
  * :func:`render_cuda` renders it as one ``__global__`` function, templated
    on ``scalar_t`` and instantiated for ``float`` and ``double``, plus an
    ``extern "C"`` launcher (built by :mod:`repro_torch.kernels.build`);
    :func:`emulate` runs the same program tile by tile with torch on the CPU
    — same extensions, shifts and guarded loads — as the kernel's plain
    version.

What bounds it on the H100: device-memory bytes.  A stencil does a few
operations per element it reads, far below the card's balance, so the least
time is the bytes of the inputs read once and the outputs written once over
3.35 TB/s.  float64 runs at a fraction of float32's arithmetic rate on this
card, but the kernel stays bound by memory, so the design is the same for
both.  What the design does about the bytes:

  * one thread block computes one output tile.  For each aux, in order, its
    threads stride over the tile widened by ``2·ext`` and evaluate the aux
    into dynamic shared memory; the consumers read it back at their shifts.
    No aux array is ever written to device memory — RACE's reuse is realised
    as shared-memory hits, never as recomputation;
  * operands are read in place through their affine indices — a negative
    coefficient is just ``a < 0``, a repeated level or a constant dimension
    is just another affine index — and outputs are written straight into
    their own dimension order.  The per-call transposes, flips, pads and
    ``3**k`` halo copies the Pallas path made to feed BlockSpec (each a full
    pass over device memory) do not exist here;
  * every global load is guarded (outside the array reads 0: such cells lie
    only in tile overhang and in aux corners no consumer reads) and every
    store is guarded to the statement extents; offsets are 64-bit;
  * constants are emitted at full double precision as ``scalar_t(<repr>)``
    (the reference Pallas kernel rounds every constant to float32).

nvcc contracts ``a*b + c`` into FMA by default, which rounds differently
from torch's eager ops; the differences sit far inside the ``plan``
tolerance (float32 1e-5, float64 1e-12), so no flag disables it.
"""
from __future__ import annotations

import ctypes
import itertools
from dataclasses import dataclass
from math import isfinite, prod
from typing import Mapping

import torch

from ..core.depgraph import Plan
from ..core.ir import Const, Expr, Node, Ref, expr_refs
from .blocks import LaunchGeometry, build_geometry
from .facts import R_HOPPER_DTYPE, FallbackReason, LoweringError
from .geometry import analyze_plan, aux_shift

#: operand dtypes the kernel is instantiated for, with their byte widths;
#: the launcher's dtype code is the position in this table
KERNEL_DTYPES = {"float32": 4, "float64": 8}

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_FUNCS = ("sin", "cos", "exp", "log", "sqrt", "tanh", "abs")


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


@dataclass(frozen=True)
class Output:
    """One body statement's interior output, in its own dimension order."""

    name: str
    levels: tuple  # loop level of each output dimension
    shape: tuple


@dataclass(frozen=True)
class AuxTile:
    """One aux array's tile in shared memory."""

    name: str
    levels: tuple  # covered loop levels, ascending
    ext: tuple  # per-level tile extension (m entries)
    widths: tuple  # per-level box width: tile + 2·ext, 1 where uncovered
    strides: tuple  # per-level element stride in the box, 0 where uncovered
    offset: int  # first element in shared memory

    @property
    def size(self) -> int:
        return prod(self.widths)


@dataclass(frozen=True)
class TileProgram:
    """Everything the CUDA rendering and the CPU emulator share."""

    geometry: LaunchGeometry
    dtype: str  # "float32" | "float64"
    operands: tuple  # Operand, sorted by name
    scalars: tuple  # scalar names, sorted
    outputs: tuple  # Output, one per body statement
    aux: tuple  # AuxTile, topological (producers first)
    aux_exprs: tuple  # Expr per aux
    body: tuple  # Expr per output

    @property
    def smem_elems(self) -> int:
        return sum(a.size for a in self.aux)

    @property
    def smem_bytes(self) -> int:
        return self.smem_elems * KERNEL_DTYPES[self.dtype]


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
    analysis = analyze_plan(plan)
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
    operands = []
    for nm in names:
        shape = tuple(shapes[nm])
        if len(shape) != analysis.arrays[nm].ndim:
            raise ValueError(
                f"{nm}: environment array has rank {len(shape)}, plan "
                f"references rank {analysis.arrays[nm].ndim}")
        operands.append(Operand(nm, shape, _contiguous_strides(shape)))

    geo = build_geometry(plan, analysis, KERNEL_DTYPES[dtype], block_rows,
                         block_cols, block_inner)
    m = geo.m
    aux, offset = [], 0
    for a in plan.aux_order:
        ext = analysis.ext[a.name]
        widths = [1] * m
        strides = [0] * m
        acc = 1
        for l in geo.order:
            if l in a.levels:
                widths[l - 1] = geo.tile[l - 1] + 2 * ext[l - 1]
                strides[l - 1] = acc
                acc *= widths[l - 1]
        t = AuxTile(a.name, tuple(sorted(a.levels)), tuple(ext),
                    tuple(widths), tuple(strides), offset)
        aux.append(t)
        offset += t.size

    aux_exprs = tuple(plan.aux_exprs[a.name] for a in plan.aux_order)
    body = tuple(st.rhs for st in plan.body)
    scalars = tuple(sorted({r.name for e in aux_exprs + body
                            for r in expr_refs(e) if not r.subs}))
    outputs = []
    for st in plan.body:
        levels = tuple(s.s for s in st.lhs.subs)
        outputs.append(Output(st.lhs.name, levels,
                              tuple(geo.extents[l - 1] for l in levels)))
    return TileProgram(geometry=geo, dtype=dtype, operands=tuple(operands),
                       scalars=scalars, outputs=tuple(outputs),
                       aux=tuple(aux), aux_exprs=aux_exprs, body=body)


# ---------------------------------------------------------------------------
# CUDA C++ rendering
# ---------------------------------------------------------------------------


class _Region:
    """Code for one region of a tile: an aux box or the output tile."""

    def __init__(self, tp: TileProgram, ext: tuple):
        self.tp = tp
        self.ext = ext
        self.loads: dict = {}  # base Ref -> local variable name
        self.lines: list = []

    def expr(self, e: Expr) -> str:
        tp = self.tp
        if isinstance(e, Const):
            if not isfinite(e.val):
                raise ValueError(f"constant {e.val!r} has no C++ literal")
            return f"scalar_t({float(e.val)!r})"
        if isinstance(e, Ref):
            if not e.subs:
                return f"sc{tp.scalars.index(e.name)}"
            aux = next((a for a in tp.aux if a.name == e.name), None)
            if aux is not None:
                sh = aux_shift(e)
                terms = [f"(p{l} + {sh.get(l, 0) + aux.ext[l - 1] - self.ext[l - 1]}) * {aux.strides[l - 1]}"
                         for l in aux.levels]
                return f"smem[{aux.offset} + " + " + ".join(terms) + "]"
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

    def _load(self, ref: Ref) -> str:
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
            idx.append(f"      const long long {dv} = {rhs};")
            guard.append(f"{dv} >= 0 && {dv} < {op.shape[d]}LL")
            off.append(f"{dv} * {op.strides[d]}LL")
        self.lines.append(f"    scalar_t {var} = scalar_t(0);")
        self.lines.append("    {")
        self.lines.extend(idx)
        self.lines.append(f"      if ({' && '.join(guard) or 'true'}) "
                          f"{var} = in{k}[{' + '.join(off) or '0'}];")
        self.lines.append("    }")
        return var


def _region_loop(tp: TileProgram, levels: tuple, widths: dict, ext: tuple,
                 guard_hi: bool) -> list:
    """Loop header: thread-strided sweep of a box, fastest level first."""
    g = tp.geometry
    order = [l for l in g.order if l in levels]
    size = prod(widths[l] for l in order)
    lines = [f"  for (int e = threadIdx.x; e < {size}; e += {g.threads}) {{",
             "    int q = e;"]
    for k, l in enumerate(order):
        if k == len(order) - 1:
            lines.append(f"    const int p{l} = q;")
        else:
            lines.append(f"    const int p{l} = q % {widths[l]}; "
                         f"q /= {widths[l]};")
        lines.append(f"    const long long i{l} = t{l} + "
                     f"(p{l} - {ext[l - 1]});")
    if guard_hi:
        cond = " || ".join(f"i{l} > {g.hi[l - 1]}LL" for l in order)
        lines.append(f"    if ({cond}) continue;")
    lines.append("    (void)q;")
    return lines


def render_cuda(tp: TileProgram) -> str:
    """CUDA C++ source of the plan's kernel and its ``extern "C"`` launcher.

    The launcher is ``int race_stencil_launch(int dtype, const void* const*
    ins, void* const* outs, const void* scalars, void* stream)``: dtype is 0
    for float and 1 for double; it returns ``cudaGetLastError()``."""
    g = tp.geometry
    m = g.m
    n_in, n_out = len(tp.operands), len(tp.outputs)
    lines = [
        "// Generated by repro_torch.lowering.emit.render_cuda: the RACE "
        "stencil kernel",
        f"// of one plan, depth {m}, tile {g.tile}, {len(tp.aux)} aux in "
        f"shared memory.",
        '#include "race_stencil.cuh"',
        "",
        "namespace {",
        "",
        "template <typename scalar_t>",
        f"__global__ void __launch_bounds__({g.threads}) race_stencil_kernel(",
        f"    const RaceArgs<scalar_t, {n_in}, {n_out}> args) {{",
    ]
    if tp.aux:
        lines += [
            "  extern __shared__ __align__(16) unsigned char race_smem[];",
            "  scalar_t* const smem = reinterpret_cast<scalar_t*>(race_smem);",
        ]
    for k in range(n_in):
        lines.append(f"  const scalar_t* const __restrict__ in{k} = "
                     f"args.in[{k}];")
    for k in range(n_out):
        lines.append(f"  scalar_t* const __restrict__ out{k} = args.out[{k}];")
    for k in range(len(tp.scalars)):
        lines.append(f"  const scalar_t sc{k} = args.scalars[{k}];")
    lines.append("  long long bid = blockIdx.x;")
    for l in g.order:
        lines.append(f"  const long long t{l} = {g.lo[l - 1]}LL + "
                     f"(bid % {g.nb[l - 1]}) * {g.tile[l - 1]}; "
                     f"bid /= {g.nb[l - 1]};")
    lines.append("  (void)bid;")

    for aux, expr in zip(tp.aux, tp.aux_exprs):
        lines.append(f"  // aux {aux.name}: levels {aux.levels}, "
                     f"ext {aux.ext}")
        widths = {l: aux.widths[l - 1] for l in aux.levels}
        lines += _region_loop(tp, aux.levels, widths, aux.ext, False)
        reg = _Region(tp, aux.ext)
        val = reg.expr(expr)
        lines += reg.lines
        pos = " + ".join(f"p{l} * {aux.strides[l - 1]}" for l in aux.levels)
        lines.append(f"    smem[{aux.offset} + {pos}] = {val};")
        lines.append("  }")
        lines.append("  __syncthreads();")

    levels = tuple(range(1, m + 1))
    lines.append("  // body: one output tile")
    lines += _region_loop(tp, levels, {l: g.tile[l - 1] for l in levels},
                          (0,) * m, True)
    reg = _Region(tp, (0,) * m)
    vals = [reg.expr(e) for e in tp.body]
    lines += reg.lines
    for k, (out, val) in enumerate(zip(tp.outputs, vals)):
        strides = _contiguous_strides(out.shape)
        off = " + ".join(f"(i{l} - {g.lo[l - 1]}LL) * {st}LL"
                         for l, st in zip(out.levels, strides))
        lines.append(f"    out{k}[{off}] = {val};")
    lines += ["  }", "}", ""]

    smem = f"{tp.smem_elems} * sizeof(scalar_t)"
    lines += [
        "template <typename scalar_t>",
        "int launch(const void* const* ins, void* const* outs, "
        "const void* scalars,",
        "           cudaStream_t stream) {",
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
        f"  race_stencil_kernel<scalar_t><<<{g.n_tiles}u, {g.threads}, "
        "smem, stream>>>(a);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
        "",
        "}  // namespace",
        "",
        'extern "C" int race_stencil_launch(int dtype, const void* const* '
        "ins,",
        "                                   void* const* outs, "
        "const void* scalars,",
        "                                   void* stream) {",
        "  const cudaStream_t s = static_cast<cudaStream_t>(stream);",
        "  if (dtype == 0) return launch<float>(ins, outs, scalars, s);",
        "  if (dtype == 1) return launch<double>(ins, outs, scalars, s);",
        "  return static_cast<int>(cudaErrorInvalidValue);",
        "}",
        "",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CPU emulator: the kernel's plain version
# ---------------------------------------------------------------------------


def emulate(tp: TileProgram, env: Mapping) -> dict:
    """Run the tile program tile by tile with torch, as the kernel does.

    Each value carries one axis per loop level (size 1 where it does not
    vary).  Aux boxes, their extensions and shifted reads, guarded loads and
    guarded stores all follow :func:`render_cuda`."""
    g = tp.geometry
    m = g.m
    dt = _TORCH_DTYPES[tp.dtype]
    data = {o.name: env[o.name] for o in tp.operands}
    dev = data[tp.operands[0].name].device
    scal = {nm: torch.as_tensor(env[nm]).to(device=dev, dtype=dt)
            for nm in tp.scalars}
    aux_of = {a.name: a for a in tp.aux}
    outs = [torch.empty(o.shape, dtype=dt, device=dev) for o in tp.outputs]

    def axis(l: int, vec):
        shape = [1] * m
        shape[l - 1] = vec.numel()
        return vec.reshape(shape)

    def load(ref: Ref, coords: dict):
        arr = data[ref.name]
        idx, ok = [], True
        for d, (a, s, b) in enumerate(affine(ref)):
            ix = (torch.tensor(b, device=dev) if s == 0
                  else axis(s, a * coords[s] + b))
            ok = ok & (ix >= 0) & (ix < arr.shape[d])
            idx.append(ix.clamp(0, arr.shape[d] - 1))
        val = torch.where(ok, arr[tuple(idx)], torch.zeros((), dtype=dt,
                                                           device=dev))
        return val.reshape([1] * m) if val.dim() == 0 else val

    def evaluate(e: Expr, coords: dict, ext: tuple, boxes: dict, memo: dict):
        def ev(x: Expr):
            if isinstance(x, Const):
                return torch.tensor(x.val, dtype=dt, device=dev)
            if isinstance(x, Ref):
                if not x.subs:
                    return scal[x.name]
                if x.name in aux_of:
                    aux, sh = aux_of[x.name], aux_shift(x)
                    sl = []
                    for l in range(1, m + 1):
                        if l in aux.levels:
                            s0 = sh.get(l, 0) + aux.ext[l - 1] - ext[l - 1]
                            sl.append(slice(s0, s0 + g.tile[l - 1]
                                            + 2 * ext[l - 1]))
                        else:
                            sl.append(slice(0, 1))
                    return boxes[x.name][tuple(sl)]
                val = memo.get(x)
                if val is None:
                    val = memo[x] = load(x, coords)
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

    for tix in itertools.product(*(range(n) for n in g.nb)):
        t0 = [g.lo[k] + tix[k] * g.tile[k] for k in range(m)]
        boxes: dict = {}
        for aux, expr in zip(tp.aux, tp.aux_exprs):
            coords = {l: t0[l - 1] - aux.ext[l - 1] + torch.arange(
                aux.widths[l - 1], device=dev) for l in aux.levels}
            val = evaluate(expr, coords, aux.ext, boxes, {})
            shape = [aux.widths[l - 1] for l in range(1, m + 1)]
            boxes[aux.name] = val.expand(shape)
        coords = {l: t0[l - 1] + torch.arange(g.tile[l - 1], device=dev)
                  for l in range(1, m + 1)}
        keep = [min(g.tile[k], g.hi[k] - t0[k] + 1) for k in range(m)]
        memo: dict = {}
        for out, o, rhs in zip(outs, tp.outputs, tp.body):
            val = evaluate(rhs, coords, (0,) * m, boxes, memo)
            val = val.expand(list(g.tile))[tuple(slice(0, n) for n in keep)]
            region = tuple(slice(t0[l - 1] - g.lo[l - 1],
                                 t0[l - 1] - g.lo[l - 1] + keep[l - 1])
                           for l in o.levels)
            out[region] = val.permute([l - 1 for l in o.levels])
    return {o.name: out for o, out in zip(tp.outputs, outs)}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


#: the C interface of a rendered source (see :func:`render_cuda`)
_SYMBOLS = {
    "race_stencil_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]),
    "race_stencil_error": (ctypes.c_char_p, [ctypes.c_int]),
}


class LoweredStencil:
    """One plan specialized for one environment signature: the kernel's
    wrapper.

    :meth:`apply` runs :func:`emulate` when the operands lie on the CPU, and
    launches the compiled kernel when they lie on a CUDA device — or raises:
    there is no fallback from the card to the emulator.  ``launches`` counts
    this wrapper's kernel launches."""

    def __init__(self, tp: TileProgram):
        self.tp = tp
        self.source = render_cuda(tp)
        self.launches = 0
        self._lib = None

    def apply(self, env: Mapping) -> dict:
        tp = self.tp
        ins = [env[o.name] for o in tp.operands]
        if all(t.device.type == "cpu" for t in ins):
            return emulate(tp, env)
        return self._launch(env, ins)

    __call__ = apply

    def _launch(self, env: Mapping, ins: list) -> dict:
        tp = self.tp
        dev = ins[0].device
        dt = _TORCH_DTYPES[tp.dtype]
        for o, t in zip(tp.operands, ins):
            if t.device != dev or dev.type != "cuda":
                raise ValueError(
                    f"{o.name} lies on {t.device}; the kernel takes operands "
                    f"on one CUDA device ({dev})")
            if t.dtype != dt:
                raise ValueError(f"{o.name} is {t.dtype}, the kernel was "
                                 f"specialized for {dt}")
            if tuple(t.shape) != o.shape:
                raise ValueError(f"{o.name} has shape {tuple(t.shape)}, the "
                                 f"kernel was specialized for {o.shape}")
            if not t.is_contiguous():
                raise ValueError(f"{o.name} is not contiguous")
        if self._lib is None:
            from ..kernels.build import load

            self._lib = load(self.source, _SYMBOLS)
        # the launcher's runtime calls act on the thread's current device
        with torch.cuda.device(dev):
            scal = None
            if tp.scalars:
                scal = torch.stack([torch.as_tensor(env[nm]).to(
                    device=dev, dtype=dt) for nm in tp.scalars])
            outs = [torch.empty(o.shape, dtype=dt, device=dev)
                    for o in tp.outputs]
            in_ptrs = (ctypes.c_void_p * len(ins))(
                *[t.data_ptr() for t in ins])
            out_ptrs = (ctypes.c_void_p * len(outs))(
                *[t.data_ptr() for t in outs])
            rc = self._lib.race_stencil_launch(
                list(KERNEL_DTYPES).index(tp.dtype), in_ptrs, out_ptrs,
                None if scal is None else scal.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = self._lib.race_stencil_error(rc).decode()
            raise RuntimeError(f"race stencil kernel launch failed: CUDA "
                               f"error {rc} ({msg})")
        self.launches += 1
        return {o.name: t for o, t in zip(tp.outputs, outs)}


def specialize_stencil(plan: Plan, shapes: Mapping, dtypes: Mapping,
                       block_rows: int = 0, block_cols: int = 0,
                       block_inner: int = 0) -> LoweredStencil:
    """Build the kernel's wrapper for one environment signature (the CUDA
    source is rendered here and compiled at the first launch on a card)."""
    return LoweredStencil(tile_program(plan, shapes, dtypes, block_rows,
                                       block_cols, block_inner))
