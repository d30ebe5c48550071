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
    on the storage type ``store_t`` and the compute type ``acc_t`` and
    instantiated for the program's dtype, plus an ``extern "C"`` launcher
    (built by :mod:`repro_torch.kernels.build`);
    :func:`emulate` runs the same march with torch on the CPU — same rings,
    slots, warm-up, segment ends, staged planes and guarded loads — as the
    kernel's plain version.

What bounds it on the H100: device-memory bytes.  A stencil does a few
operations per element it reads, far below the card's balance, so the least
time is the bytes of the inputs read once and the outputs written once over
3.35 TB/s.  float64 runs at a fraction of float32's arithmetic rate on this
card, but the kernel stays bound by memory, so the design is the same for
every dtype.  float16 and bfloat16 halve the bytes: they are stored at 2
bytes and computed in float (shared memory, registers and scalars), each
output rounded once to nearest even as it is stored, so a half plan has the
float32 plan's geometry.  What the design does about the bytes (a 2.5-D
streaming kernel):

  * a block owns a tile of the plane of every level but the stream level
    and marches along a segment of it, one plane per step.  Each aux that
    covers the stream level is a ring of planes in shared memory over its
    exact one-sided range; each step evaluates every aux's leading plane
    once, then one output plane.  No aux array is ever written to device
    memory, and no aux value is recomputed in another plane's halo beyond
    the plane tile's own — RACE's reuse is realised as shared-memory hits;
  * operands read at unit positive coefficients are staged one plane
    window per step with ``cp.async`` (zero-filled outside the array),
    one step ahead (double buffering); PTX has no 2-byte ``cp.async``, so
    a half operand's next plane is loaded into registers at the head of
    a step, in flight while the step computes, and converted into the
    ring after its body (:func:`_next_plane`; its first plane by guarded
    converting loads).  The rest
    (strided, mirrored, gathered) are read in place through their affine
    indices with guarded 64-bit loads, converted as they are read.
    Outputs are written straight into their own dimension order.  The
    per-call transposes, flips, pads and ``3**k`` halo copies the Pallas
    path made to feed BlockSpec do not exist here;
  * rank-0 aux (loop-invariant; the reference's ``scalar-aux``) are
    evaluated once per thread into registers at the top of the kernel;
  * in-plane offsets are 32-bit where they fit, plane bases 64-bit, and
    each ring's slot base rotates once per step;
  * a step is fixed work per thread: each box a fully unrolled count of
    rounds over the thread's fixed elements (:class:`_Maps`), an aux box
    whose rings all span the plane swept by its slot's own index (one
    pitch for all such rings: every read is that index plus a constant),
    a phase's such boxes packed end to end; the schedule's phases (one
    barrier before each) are the only barriers, and ``__launch_bounds__`` asks
    for the blocks an SM the geometry gives (:func:`~.blocks.
    launch_blocks`);
  * a batch (``run_batch``; the reference's ``jax.vmap`` over
    ``pallas_call``) is the grid's second axis: ``blockIdx.y`` is the
    example, each pointer moves by its per-example count, and the rank-0
    aux, evaluated from that example's scalars, are per example.  The
    schedule is the chooser's for the launch's batch: short segments only
    where the batch does not fill the grid (:func:`~.blocks.
    segment_length`), so a source serves every batch size on one side of
    that line;
  * constants are emitted at full double precision as ``acc_t(<repr>)``
    (the reference Pallas kernel rounds every constant to float32);
  * a caller that wants only each output's sum (a scalar's adjoint: the
    S x C products ``g b`` of the LM mixer's taps) runs the summed kernel
    (``render_cuda(tp, summed=True)``): no output point is stored, each
    thread adds its points over its march in double, the block reduces
    them, and one partial per block is written, ``(batch, n_tiles)``.

nvcc contracts ``a*b + c`` into FMA by default, which rounds differently
from torch's eager ops; the differences sit far inside the ``plan``
tolerance (float32 1e-5, float64 1e-12), so no flag disables it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from math import isfinite, prod
from typing import Mapping, NamedTuple

import torch

from ..core.depgraph import Plan
from ..core.ir import Const, Expr, Node, Ref, expr_refs
from .blocks import BODY, STATIC_SHARED, LaunchGeometry, build_geometry
from .facts import R_HOPPER_DTYPE, FallbackReason, LoweringError
from .geometry import kernel_analysis


class KernelDtype(NamedTuple):
    """How the kernel holds one operand dtype."""

    storage: str  # C++ type of an element in device memory
    width: int  # its bytes: operand and output pointer arithmetic
    compute: str  # dtype of the arithmetic, shared memory and the scalars
    shared: int  # bytes of one shared-memory element (the compute type's)
    acc: str  # C++ compute type
    header: str  # the csrc/ header the kernel includes


#: operand dtypes the kernel is instantiated for; the launcher's dtype code
#: is the position in this table.  Only a half kernel includes the half
#: headers (``race_half.cuh``), which would slow every other build.
KERNEL_DTYPES = {
    "float32": KernelDtype("float", 4, "float32", 4, "float",
                           "race_stencil.cuh"),
    "float64": KernelDtype("double", 8, "float64", 8, "double",
                           "race_stencil.cuh"),
    "float16": KernelDtype("__half", 2, "float32", 4, "float",
                           "race_half.cuh"),
    "bfloat16": KernelDtype("__nv_bfloat16", 2, "float32", 4, "float",
                            "race_half.cuh"),
}

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

    The kernel computes it in the operand dtype's compute type and stores
    it in the operand dtype; ``dtype`` is the dtype the wrapper returns: the
    env's output array's where the env carries one (as the ``"torch"``
    backend, which writes into a copy of that array), else the operand
    dtype."""

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
    dtype: str  # operand dtype, a key of KERNEL_DTYPES
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
        return self.smem_elems * KERNEL_DTYPES[self.dtype].shared

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

    @property
    def rounds_per_step(self) -> int:
        """Rounds the block's threads take in one step of the march: the
        staged operands' next planes, the aux boxes and the body
        (:func:`step_loops`)."""
        return sum(x.rounds for x in step_loops(self))

    @property
    def rounds_per_point(self) -> float:
        return self.rounds_per_step / self.geometry.plane_points

    @property
    def lane_use(self) -> float:
        """The share of a step's thread rounds that hold an element of a
        box (a linear box's pitch padding and the threads past a box's
        last element hold none)."""
        loops = step_loops(self)
        return sum(x.useful for x in loops) / max(1, sum(
            x.rounds for x in loops) * self.geometry.threads)


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
                 block_inner: int = 0, batch: int = 1) -> TileProgram:
    """Specialize a plan for one environment signature, for launches of
    ``batch`` examples.

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
    geo = build_geometry(plan, KERNEL_DTYPES[dtype].shared, block_rows,
                         block_cols, block_inner, batch)
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


class _Map(NamedTuple):
    """A thread-to-element map of one box shape: element ``e`` of a round is
    ``threadIdx.x + n * threads``, its position along ``levels`` (fastest
    first) the digits of ``e`` in the radices ``widths`` (the last
    unbounded).  Each thread's digits of ``threadIdx.x`` are computed once,
    before the march (``m<id>_<level>``); a round adds the digits of
    ``n * threads``, known when the source is rendered, with a carry only
    where one can occur, so the march holds no division."""

    ident: int
    levels: tuple
    widths: tuple


class _Maps:
    """The maps a kernel uses, each rendered once before the march."""

    def __init__(self, threads: int):
        self.threads = threads
        self.maps: dict = {}

    def get(self, levels, widths) -> _Map:
        key = (tuple(levels), tuple(widths))
        if key not in self.maps:
            self.maps[key] = _Map(len(self.maps), *key)
        return self.maps[key]

    def prologue(self) -> list:
        lines = []
        for mp in self.maps.values():
            acc = 1
            for i, (l, w) in enumerate(zip(mp.levels, mp.widths)):
                v = "threadIdx.x" if acc == 1 else f"threadIdx.x / {acc}"
                if i < len(mp.levels) - 1:
                    v = f"({v}) % {w}"
                lines.append(f"  const int m{mp.ident}_{l} = {v};")
                acc *= w
        return lines

    def round(self, mp: _Map, n: int, name: str = "p") -> list:
        """Lines defining ``<name><level>`` for each level of the map at
        round ``n``."""
        t = self.threads
        digits, rest = [], n * t
        for w in mp.widths[:-1]:
            digits.append(rest % w)
            rest //= w
        digits.append(rest)
        lines, carry, acc = [], False, 1
        for i, (l, w, d) in enumerate(zip(mp.levels, mp.widths, digits)):
            most = min(w - 1, (t - 1) // acc)
            acc *= w
            base = f"m{mp.ident}_{l} + {d}" + (f" + y{mp.ident}_{i - 1}"
                                               if carry else "")
            last = i == len(mp.levels) - 1
            if not last and most + d + carry >= w:
                lines += [f"      const int y{mp.ident}_{i} = {base} >= {w};",
                          f"      const int {name}{l} = {base} - "
                          f"(y{mp.ident}_{i} ? {w} : 0);"]
                carry = True
            else:
                lines.append(f"      const int {name}{l} = {base};")
                carry = False
        return lines


def _rounds(size: int, threads: int) -> list:
    """``(n, bound)`` per round of a box of ``size`` elements: ``bound`` the
    threads whose element lies in the box (``threads``: all)."""
    return [(n, min(threads, size - n * threads))
            for n in range(-(-size // threads))]


class _Box:
    """Code for one box of a step (an aux plane, an aux box evaluated once
    per block, or the output plane) or, with ``key=None``, for the rank-0
    aux at the top of the kernel.  ``linear``: a thread's element is the
    ring slot's own index ``e`` (the box and every ring it reads laid out
    at the common pitch), so each read is at ``e`` plus a constant."""

    def __init__(self, tp: TileProgram, key, linear: bool = False):
        g = tp.geometry
        self.tp, self.key, self.linear = tp, key, linear
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

    @property
    def plane(self) -> list:
        return [l for l in self.tp.geometry.order if l in self.levels]

    @property
    def size(self) -> int:
        return prod(self.widths[l - 1] for l in self.plane)

    def map(self, maps: _Maps) -> _Map:
        return maps.get(self.plane, [self.widths[l - 1] for l in self.plane])

    def round_header(self, maps: _Maps, n: int) -> list:
        """The element of round ``n``: ``p<l>`` from the thread's map and
        each covered level's index ``i<l>``."""
        return maps.round(self.map(maps), n) + self._indices()

    def _indices(self) -> list:
        g = self.tp.geometry
        lines = [f"      const int i{l} = t{l} + ({self.lo[l - 1]} + p{l});"
                 for l in self.plane]
        if self.streamed:
            lines.append(f"      const int i{g.s_level} = z + {self.lead};")
        return lines

    def expr(self, e: Expr) -> str:
        tp = self.tp
        if isinstance(e, Const):
            if not isfinite(e.val):
                raise ValueError(f"constant {e.val!r} has no C++ literal")
            return f"acc_t({float(e.val)!r})"
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
                return f"(acc_t(1) / {self.expr(e.kids[0])})"
            return (f"({self.expr(e.kids[0])} {e.op} "
                    f"{self.expr(e.kids[1])})")
        raise TypeError(e)

    def _read(self, rd) -> str:
        g = self.tp.geometry
        r = g.rings[rd.ring]
        base = f"b{rd.ring}_{rd.back}" if r.streamed else str(r.offset)
        if self.linear:
            const = sum(rd.offset[l - 1] * r.strides[l - 1]
                        for l in g.order if l in r.levels)
            return f"smem[{base} + e + {const}]"
        terms = [f"(p{l} + {rd.offset[l - 1]}) * {r.strides[l - 1]}"
                 for l in g.order if l in r.levels]
        return f"smem[{base} + " + (" + ".join(terms) or "0") + "]"

    def _load(self, ref: Ref) -> str:
        """A guarded read from device memory (outside the array reads 0),
        in 64-bit index arithmetic, converted to ``acc_t``."""
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
        self.lines.append(f"      acc_t {var} = acc_t(0);")
        self.lines.append("      {")
        self.lines.extend(idx)
        self.lines.append(f"        if ({' && '.join(guard) or 'true'}) "
                          f"{var} = race_acc(in{k}[{' + '.join(off) or '0'}]);")
        self.lines.append("      }")
        return var


def linear_boxes(tp: TileProgram) -> set:
    """The aux rings on a plane whose box a thread sweeps by the slot's own
    index (:class:`_Box` ``linear``): the ring and every ring it reads span
    all plane levels (so all are laid out at the common pitch) and it reads
    nothing from device memory.  A round then computes no index at all;
    the pitch's padding elements are computed too, and never read."""
    g = tp.geometry
    full = {k for k, r in enumerate(g.rings)
            if all(l in r.levels for l in g.order)}
    out = set()
    for k, e in enumerate(tp.aux_exprs):
        r = g.rings[k]
        refs = [x for x in expr_refs(e) if x.subs]
        if (r.streamed and k in full
                and all((k, x) in g.reads and g.reads[k, x].ring in full
                        for x in refs)):
            out.add(k)
    return out


class StepLoop(NamedTuple):
    """One sweep of a step over the block's threads: the boxes it covers
    (aux ring indices, or :data:`BODY`, or ``("stage", ring)``), the
    elements they hold and the rounds the threads take."""

    phase: int
    boxes: tuple
    useful: int  # elements of the boxes
    swept: int  # elements swept (a linear box's pitch padding included)
    rounds: int


def step_loops(tp: TileProgram) -> list:
    """The sweeps of one step of the march, in order: the staged operands'
    next planes, then each phase's linear aux boxes packed into one
    sweep (the slots laid end to end), its other aux boxes one sweep each,
    and the body in its phase."""
    g = tp.geometry
    t = g.threads
    out = [StepLoop(-1, (("stage", k),), r.plane, r.plane,
                    -(-r.plane // t))
           for k, r in enumerate(g.rings) if r.operand]
    if not g.s_level:
        out = []
    lin = linear_boxes(tp)
    body = prod(g.tile[l - 1] for l in g.order)
    for ph in g.phases:
        aux = [k for k in range(len(tp.aux_exprs))
               if g.rings[k].streamed and g.rings[k].phase == ph]
        packed = [k for k in aux if k in lin]
        if packed:
            swept = sum(g.rings[k].slot for k in packed)
            out.append(StepLoop(ph, tuple(packed),
                                sum(g.rings[k].plane for k in packed),
                                swept, -(-swept // t)))
        for k in aux:
            if k not in lin:
                out.append(StepLoop(ph, (k,), g.rings[k].plane,
                                    g.rings[k].plane,
                                    -(-g.rings[k].plane // t)))
        if ph == g.body_phase:
            out.append(StepLoop(ph, (BODY,), body, body, -(-body // t)))
    return out


class _Window(NamedTuple):
    """Code for one staged operand's plane window at one step: threads run
    the operand's own contiguous level fastest, so that a warp's loads
    coalesce whatever the ring's element order."""

    ix: int  # the operand's position: ``in<ix>``
    head: list  # the plane's row ``zz``, ``zok`` and its base ``src``
    map: _Map  # the thread's elements
    elem: list  # indices ``j<l>`` of the element ``p<l>`` (in the slot)
    guard: list  # conditions of a read inside the array
    off: str  # the element's offset from ``src``
    pos: str  # its offset in the ring's slot


def _window(tp: TileProgram, k: int, step: str, maps: _Maps) -> _Window:
    g = tp.geometry
    r = g.rings[k]
    ix = next(i for i, o in enumerate(tp.operands) if o.ring == k)
    op = tp.operands[ix]
    ds = op.dims.index(g.s_level)
    plane = [l for l in reversed(op.dims) if l in g.order]
    inner = [d for d in range(len(op.dims)) if d != ds]
    head = [
        f"      const int zz = z0 + ({step}) + {r.lead};",
        f"      const bool zok = zz >= 0 && zz < {op.shape[ds]};",
        f"      const store_t* const src = zok ? in{ix} + (long long)zz * "
        f"{op.strides[ds]}LL : in{ix};",
    ]
    mp = maps.get(plane, [r.widths[l - 1] for l in plane])
    elem = [f"        const int j{l} = t{l} + ({r.lo[l - 1]} + p{l});"
            for l in plane]
    guard = ["zok"] + [f"j{op.dims[d]} >= 0 && j{op.dims[d]} < {op.shape[d]}"
                       for d in inner]
    off = _offset([(f"j{op.dims[d]}", op.strides[d]) for d in inner],
                  _fits32(op.shape, op.strides, inner))
    pos = _offset([(f"p{l}", r.strides[l - 1]) for l in plane], True)
    return _Window(ix, head, mp, elem, guard, off, pos)


def _slot_base(tp: TileProgram, k: int, slot: str) -> str:
    r = tp.geometry.rings[k]
    return (f"      acc_t* const dst = smem + {r.offset} + ({slot}) * "
            f"{r.slot};")


def _guarded(bound: int, threads: int, lines: list) -> list:
    """``lines`` in a block, run by the threads under ``bound``."""
    cond = "{" if bound >= threads else f"if (threadIdx.x < {bound}) {{"
    return [f"      {cond}"] + ["  " + ln for ln in lines] + ["      }"]


def _stage(tp: TileProgram, k: int, step: str, slot: str,
           maps: _Maps) -> list:
    """Copy one operand plane window into its ring slot with ``race_stage``
    (``cp.async`` at 4 and 8 bytes, a converting load at 2; reads 0
    outside the array): the plane of step ``step``, in fully unrolled
    rounds of the thread's fixed elements."""
    g = tp.geometry
    w = _window(tp, k, step, maps)
    lines = ["    {"] + w.head + [_slot_base(tp, k, slot)]
    for n, bound in _rounds(g.rings[k].plane, g.threads):
        lines += _guarded(bound, g.threads, maps.round(w.map, n) + w.elem + [
            f"        const bool ok = {' && '.join(w.guard)};",
            f"        race_stage(dst + {w.pos}, ok ? src + {w.off} : "
            f"in{w.ix}, ok);"])
    return lines + ["    }"]


def _next_plane(tp: TileProgram, k: int, maps: _Maps) -> tuple:
    """A 2-byte operand's plane of step ``k + 1``, staged in two halves
    (PTX has no 2-byte ``cp.async``): ``(declarations, load, store)``.
    The load, at the head of step ``k``, issues every element a thread
    owns into ``store_t`` registers (``race_fetch``: raw, zero outside the
    array), one round after another, and keeps each one's place in the
    slot; nothing uses those registers until the store, after the body,
    converts them (``race_acc``) into the slot after the lead, which no
    read of step ``k`` touches.  So the loads are in flight while the step
    computes, as ``cp.async`` keeps a wider operand's."""
    g = tp.geometry
    r = g.rings[k]
    rounds = _rounds(r.plane, g.threads)
    w = _window(tp, k, "k + 1", maps)
    decl = [f"    store_t h{k}[{len(rounds)}];  // ring {r.name}: the next "
            "plane, raw",
            f"    int a{k}[{len(rounds)}];  // each element's place in its "
            "slot"]
    load = ["    {"] + w.head
    store = ["    {", _slot_base(tp, k, f"r{k} + 1 == {r.depth} ? 0 : "
                                       f"r{k} + 1")]
    for n, bound in rounds:
        load += _guarded(bound, g.threads, maps.round(w.map, n) + w.elem + [
            f"        const bool ok = {' && '.join(w.guard)};",
            f"        h{k}[{n}] = race_fetch(ok ? src + {w.off} : in{w.ix}, "
            "ok);",
            f"        a{k}[{n}] = {w.pos};"])
        store += _guarded(bound, g.threads, [
            f"        dst[a{k}[{n}]] = race_acc(h{k}[{n}]);"])
    return decl, load + ["    }"], store + ["    }"]


def _when(parts: list, lines: list) -> list:
    return ([f"    if ({' && '.join(parts)}) {{"] if parts else ["    {"]) + (
        lines + ["    }"])


def render_cuda(tp: TileProgram, summed: bool = False) -> str:
    """CUDA C++ source of the plan's kernel and its ``extern "C"`` launcher.

    The launcher is ``int race_stencil_launch(int dtype, const void* const*
    ins, void* const* outs, const void* scalars, int batch, void* stream)``:
    dtype is the operand dtype's position in :data:`KERNEL_DTYPES` (the
    source instantiates the kernel for the program's dtype alone, so each
    build compiles one kernel; another code is ``cudaErrorInvalidValue``);
    operands and outputs are in that dtype's storage type, the scalars in
    its compute type; it returns ``cudaGetLastError()``.  The grid is ``(tiles, batch)``: ``blockIdx.y``
    is the example, and every operand, output and scalar pointer moves by
    its per-example count (:attr:`TileProgram.example_elems`, constants of
    the signature) times ``blockIdx.y``, in 64 bits.  A single run passes
    ``batch`` 1, so one source serves every batch size.

    A step of the march: one barrier before each of the schedule's phases;
    every box as fully unrolled rounds of the
    thread's fixed elements (:class:`_Map`, :func:`step_loops`: a
    phase's linear aux boxes packed end to end, reading at the slot's
    own index plus a constant), so the march holds no ``%`` or ``/`` of an
    index.  ``__launch_bounds__`` asks for the blocks an SM that the
    block's shared memory allows (``geometry.blocks``), so that registers
    do not cut them.

    ``summed``: the kernel stores no output point.  Each thread adds its
    points of each output over its march (``race_add``, in double), the
    block sums the threads' sums (``race_block_sum``: warp shuffles, then
    shared memory) and thread 0 writes one partial per output at
    ``blockIdx.x``: output ``k``'s pointer is a double buffer of ``(batch,
    n_tiles)``.  A scalar's adjoint wants only the sum of its
    output (:meth:`LoweredStencil.apply_sum`)."""
    g = tp.geometry
    kd = KERNEL_DTYPES[tp.dtype]
    m, s = g.m, g.s_level
    n_in, n_out = len(tp.operands), len(tp.outputs)
    n_aux = len(tp.aux_exprs)
    staged = [k for k, r in enumerate(g.rings) if r.operand]
    streamed = [k for k, r in enumerate(g.rings) if r.streamed]
    maps = _Maps(g.threads)
    lines = [
        "// Generated by repro_torch.lowering.emit.render_cuda: the RACE "
        "stencil kernel",
        f"// of one plan, depth {m}, block {g.tile}, stream level {s}, "
        f"{n_aux} aux and {len(staged)} staged operands in shared memory, "
        f"{g.barriers} barrier(s) a step"
        + ("; each output summed, one partial per block." if summed
           else "."),
        f'#include "{kd.header}"',
        "",
        "namespace {",
        "",
        "template <typename store_t, typename acc_t>",
        f"__global__ void __launch_bounds__({g.threads}, {g.blocks}) "
        "race_stencil_kernel(",
        f"    const RaceArgs<store_t, acc_t, {n_in}, {n_out}> args) {{",
    ]
    if g.rings:
        lines += [
            "  extern __shared__ __align__(16) unsigned char race_smem[];",
            "  acc_t* const smem = reinterpret_cast<acc_t*>(race_smem);",
        ]
    in_elems, out_elems, n_sc = tp.example_elems
    lines.append("  const long long bz = blockIdx.y;  // the example")
    for k in range(n_in):
        lines.append(f"  const store_t* const __restrict__ in{k} = "
                     f"args.in[{k}] + bz * {in_elems[k]}LL;")
    for k in range(n_out):
        if summed:
            lines += [f"  double* const __restrict__ part{k} = "
                      f"reinterpret_cast<double*>(args.out[{k}]) + bz * "
                      f"{g.n_tiles}LL;",
                      f"  double sum{k} = 0.0;"]
        else:
            lines.append(f"  store_t* const __restrict__ out{k} = "
                         f"args.out[{k}] + bz * {out_elems[k]}LL;")
    for k in range(n_sc):
        lines.append(f"  const acc_t sc{k} = args.scalars[bz * {n_sc}LL + "
                     f"{k}];")
    for k, (nm, e) in enumerate(tp.scalar_aux):
        lines.append(f"  const acc_t ra{k} = {_Box(tp, None).expr(e)};  "
                     f"// {nm}")
    lines.append("  int bid = blockIdx.x;")
    for l in g.order:
        lines.append(f"  const int t{l} = {g.lo[l - 1]} + (bid % "
                     f"{g.nb[l - 1]}) * {g.tile[l - 1]}; bid /= "
                     f"{g.nb[l - 1]};")
    lines.append(f"  const int z0 = {g.lo[s - 1] if s else 0} + bid * "
                 f"{g.seg};")
    lines.append("  (void)bid; (void)z0; (void)bz;")
    # the thread maps, rendered once the march's code has named them
    maps_at = len(lines)

    for k in range(n_aux):
        if not g.rings[k].streamed:
            r = g.rings[k]
            lines.append(f"  // aux {r.name}: one box, levels {r.levels}, "
                         f"[{r.lo}, {r.hi}]")
            lines += _box_rounds(tp, k, maps, f"smem[{r.offset} + ") + [
                "  __syncthreads();"]

    lines.append(f"  // the march: steps {g.k0}..{g.seg - 1}, output plane "
                 f"z0 + k from step 0; {g.barriers} barrier(s) a step")
    for k in streamed:
        lines.append(f"  int r{k} = 0;  // ring {g.rings[k].name}: slot of "
                     f"its lead, (k - {g.k0}) mod {g.rings[k].depth}")
    half = kd.width == 2  # no cp.async: the next plane through registers
    if staged:  # the planes of the first step
        for k in staged:
            if g.rings[k].start <= g.k0:
                lines += _stage(tp, k, str(g.k0), "0", maps)
        if not half:
            lines.append("  race_cp_async_commit();")
    lines.append(f"  for (int k = {g.k0}; k < {g.seg}; ++k) {{")
    if staged and not half:  # this step's planes have landed
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
                     f"{r.slot};")
    for k in streamed:
        r = g.rings[k]
        if not r.operand:
            lines.append(f"    const int w{k} = {r.offset} + r{k} * "
                         f"{r.slot};  // ring {r.name}: its lead's slot")
    on = {}  # aux ring -> the condition of the steps it is written at
    for k in streamed:
        r = g.rings[k]
        if r.start > g.k0 and not r.operand:
            on[k] = f"on{k}"
            lines.append(f"    const bool on{k} = k >= {r.start};")

    def next_planes(code: dict) -> list:
        """``code[k]``, ring ``k``'s code for its plane of the next step,
        under that plane's conditions."""
        out = []
        for k in staged:
            r = g.rings[k]
            cond = [f"k + 1 < {g.seg}"] + (
                [f"k + 1 >= {r.start}"] if r.start > g.k0 + 1 else [])
            out += [f"    if ({' && '.join(cond)}) {{"] + code[k] + ["    }"]
        return out

    nexts = {k: _next_plane(tp, k, maps) for k in staged} if half else {}
    if nexts:
        lines += ["    // the next step's planes, loaded into registers now "
                  "and stored after the",
                  "    // body: the loads are in flight while the step "
                  "computes"]
        lines += [ln for k in staged for ln in nexts[k][0]]
        lines += next_planes({k: nexts[k][1] for k in staged})
    elif staged:  # cp.async into the slot after the lead
        lines += next_planes({k: _stage(
            tp, k, "k + 1", f"(r{k} + 1 == {g.rings[k].depth} ? 0 : r{k} + "
            "1)", maps) for k in staged}) + ["    race_cp_async_commit();"]

    lin, phase = linear_boxes(tp), g.phases[0]
    for loop in step_loops(tp):
        if loop.phase < 0:
            continue
        if loop.phase != phase:  # the next phase reads this one's
            lines.append("    __syncthreads();")
            phase = loop.phase
        if loop.boxes == (BODY,):
            lines += _body(tp, maps, summed)
        elif loop.boxes[0] in lin:
            lines += _linear(tp, loop, on)
        else:
            lines += _coords_aux(tp, loop.boxes[0], maps, on)
    if nexts:
        lines.append("    // the next step's planes, converted into the "
                     "slot after the lead")
        lines += next_planes({k: nexts[k][2] for k in staged})
    for k in streamed:
        lines.append(f"    r{k} = r{k} + 1 == {g.rings[k].depth} ? 0 : "
                     f"r{k} + 1;")
    lines.append("  }")
    for k in range(n_out) if summed else ():
        lines += ["  {",
                  f"    const double v = race_block_sum(sum{k});",
                  f"    if (threadIdx.x == 0) part{k}[blockIdx.x] = v;",
                  "  }"]
    lines += ["}", ""]
    lines[maps_at:maps_at] = maps.prologue()

    smem = f"{tp.smem_elems} * sizeof(acc_t)"
    lines += [
        "template <typename store_t, typename acc_t>",
        "int launch(const void* const* ins, void* const* outs, "
        "const void* scalars,",
        "           int batch, cudaStream_t stream) {",
        f"  RaceArgs<store_t, acc_t, {n_in}, {n_out}> a;",
        f"  for (int k = 0; k < {n_in}; ++k) "
        "a.in[k] = static_cast<const store_t*>(ins[k]);",
        f"  for (int k = 0; k < {n_out}; ++k) "
        "a.out[k] = static_cast<store_t*>(outs[k]);",
        "  a.scalars = static_cast<const acc_t*>(scalars);",
        f"  const size_t smem = {smem};",
        "  // the 48 KB a block has without opting in hold its static bytes",
        "  // too (a summed kernel's block sums)",
        f"  if (smem + {STATIC_SHARED if summed else 0} > 48 * 1024) {{",
        "    const cudaError_t err = cudaFuncSetAttribute(",
        "        race_stencil_kernel<store_t, acc_t>,",
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, "
        "static_cast<int>(smem));",
        "    if (err != cudaSuccess) return static_cast<int>(err);",
        "  }",
        f"  const dim3 grid({g.n_tiles}u, static_cast<unsigned>(batch));",
        f"  race_stencil_kernel<store_t, acc_t><<<grid, {g.threads}, smem, "
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
        f"  if (dtype == {list(KERNEL_DTYPES).index(tp.dtype)}) return "
        f"launch<{kd.storage}, {kd.acc}>(ins, outs, scalars, batch, s);",
        "  return static_cast<int>(cudaErrorInvalidValue);",
        "}",
        "",
    ]
    return "\n".join(lines)


def _linear(tp: TileProgram, loop: StepLoop, on: dict) -> list:
    """A phase's linear aux boxes, their slots laid end to end and swept
    in rounds: a round's threads split between at most a few boxes at
    bounds known when the source is rendered (a warp splits at most once
    between two), each thread's element ``e`` its slot's own index."""
    g = tp.geometry
    t = g.threads
    lines = [f"    // aux {', '.join(g.rings[k].name for k in loop.boxes)}:"
             f" phase {loop.phase}, {loop.rounds} rounds of the slots' "
             f"own indices"]
    vals, first = {}, 0
    spans = []
    for k in loop.boxes:
        box = _Box(tp, k, linear=True)
        vals[k] = box.expr(tp.aux_exprs[k])
        spans.append((k, first, first + g.rings[k].slot))
        first += g.rings[k].slot
    for n in range(loop.rounds):
        lo, hi = n * t, (n + 1) * t
        for k, a, b in spans:
            if b <= lo or a >= hi:
                continue
            parts = ([on[k]] if k in on else []) + (
                [f"threadIdx.x >= {a - lo}"] if a > lo else []) + (
                [f"threadIdx.x < {b - lo}"] if b < hi else [])
            lines += _when(parts, [
                f"      const int e = threadIdx.x + {lo - a};",
                f"      smem[w{k} + e] = {vals[k]};"])
    return lines


def _box_rounds(tp: TileProgram, k: int, maps: _Maps, dst: str) -> list:
    """Aux ring ``k``'s box in rounds of the thread's fixed elements with
    their indices, each value stored at ``dst`` plus its place in the
    slot (``dst`` opens the subscript)."""
    g = tp.geometry
    r = g.rings[k]
    box = _Box(tp, k)
    val = box.expr(tp.aux_exprs[k])
    pos = " + ".join(f"p{l} * {r.strides[l - 1]}" for l in box.plane) or "0"
    out = []
    for n, bound in _rounds(box.size, g.threads):
        out += _guarded(bound, g.threads, box.round_header(maps, n)
                        + box.lines + [f"        {dst}{pos}] = {val};"])
    return out


def _coords_aux(tp: TileProgram, k: int, maps: _Maps, on: dict) -> list:
    """An aux box on a plane that reads device memory or a ring off the
    common pitch."""
    r = tp.geometry.rings[k]
    return [f"    // aux {r.name}: levels {r.levels}, [{r.lo}, {r.hi}], "
            f"ring of {r.depth}, lead {r.lead}, phase {r.phase}"] + (
        _when([on[k]] if k in on else [],
              _box_rounds(tp, k, maps, f"smem[w{k} + ")))


def _body(tp: TileProgram, maps: _Maps, summed: bool) -> list:
    """One output plane, in rounds of the thread's fixed points."""
    g = tp.geometry
    s = g.s_level
    box = _Box(tp, BODY)
    vals = [box.expr(e) for e in tp.body]
    store = []
    for k, (out, val) in enumerate(zip(tp.outputs, vals)):
        if summed:
            store.append(f"        sum{k} = race_add(sum{k}, {val});")
            continue
        strides = _contiguous_strides(out.shape)
        inner = [d for d, l in enumerate(out.levels) if l != s]
        off = _offset([(f"i{out.levels[d]} - {g.lo[out.levels[d] - 1]}",
                        strides[d]) for d in inner],
                      _fits32(out.shape, strides, inner))
        if s:
            ds = out.levels.index(s)
            off = (f"(long long)(z - {g.lo[s - 1]}) * {strides[ds]}LL + "
                   f"{off}")
        store.append(f"        race_store(out{k} + ({off}), {val});")
    inside = " && ".join(f"i{l} <= {g.hi[l - 1]}" for l in g.order)
    rounds = []
    for n, bound in _rounds(box.size, g.threads):
        rounds += _guarded(bound, g.threads, box.round_header(maps, n) + [
            f"        if ({inside or 'true'}) {{"] + [
            "  " + ln for ln in box.lines + store] + ["        }"])
    cond = f"k >= 0 && z <= {g.hi[s - 1]}" if s else "k >= 0"
    return ["    // body: one output plane"] + _when([cond], rounds)


# ---------------------------------------------------------------------------
# CPU emulator: the kernel's plain version
# ---------------------------------------------------------------------------


def _warp_tree(v):
    """``__shfl_down_sync``'s tree over the last axis (32 lanes): lane 0's
    sum, each step adding lane ``i + o`` to lane ``i``."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def block_sum(v):
    """``race_block_sum`` of every block at once: ``v`` is ``(blocks,
    threads)`` (threads a multiple of 32), each warp's tree, then the tree
    over the warps' sums padded with zeros to 32."""
    warps = _warp_tree(v.reshape(v.shape[0], -1, 32))
    pad = v.new_zeros((v.shape[0], 32 - warps.shape[1]))
    return _warp_tree(torch.cat([warps, pad], dim=1))


def emulate(tp: TileProgram, env: Mapping, summed: bool = False) -> dict:
    """Run the tile program's march with torch, as the kernel does, every
    block at once (one leading axis per block).

    Values carry the block axis and one axis per loop level (size 1 where
    they do not vary).  Rank-0 aux, boxes, rings, their slots, the warm-up,
    segment ends, staged planes, guarded loads and guarded stores all follow
    :func:`render_cuda` and read the schedule from ``tp.geometry``.  As in
    the kernel, the march runs in the operand dtype's compute type (float32
    for both half types) and each output is rounded once to the operand
    dtype.  ``summed``: as ``render_cuda(tp, summed=True)``, each output's
    partial sums, ``(n_tiles,)`` in float64, added in the kernel's order:
    each thread's points over the march, then :func:`block_sum`."""
    g = tp.geometry
    m, s, B = g.m, g.s_level, g.n_tiles
    dt = _torch_dtype(KERNEL_DTYPES[tp.dtype].compute)
    data = {o.name: env[o.name].to(dt) for o in tp.operands}
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
    # summed: each thread's running sums; a box flattens with the first
    # level of ``order`` fastest, the header's ``e``, thread ``e % threads``
    sums = [torch.zeros((B, g.threads), dtype=torch.float64, device=dev)
            for _ in tp.outputs]
    perm = [0] + ([s] if s else []) + list(reversed(g.order))
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
        for k, (out, o, rhs) in enumerate(zip(outs, tp.outputs, tp.body)):
            val = evaluate(rhs, BODY, box, step).expand(
                [B] + list(body_widths))
            if summed:
                v = val.permute(perm).reshape(B, -1)
                ok = keep.permute(perm).reshape(B, -1)
                for e in range(0, v.shape[1], g.threads):
                    n = min(g.threads, v.shape[1] - e)
                    sums[k][:, :n] = torch.where(
                        ok[:, e:e + n],
                        sums[k][:, :n] + v[:, e:e + n].double(),
                        sums[k][:, :n])
                continue
            strides = _contiguous_strides(o.shape)
            flat = sum((c[l] - g.lo[l - 1]) * st
                       for l, st in zip(o.levels, strides))
            flat = flat.expand([B] + list(body_widths))
            out.view(-1)[flat[keep]] = val[keep]
    if summed:
        return {o.name: block_sum(t) for o, t in zip(tp.outputs, sums)}
    return {o.name: out.to(_torch_dtype(tp.dtype)).to(_torch_dtype(o.dtype))
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
    one launch per :data:`MAX_GRID_Y` examples, of the tile program the
    chooser gives that batch (:meth:`program`: ``tp``, or the long
    segments of a batch that fills the grid).  :meth:`apply_sum` runs the
    summed kernel for a caller that wants only each output's sum.  Each
    (program, summed) source is built at its first launch
    (:meth:`source_for`); ``launches`` counts this wrapper's kernel
    launches, of any source."""

    def __init__(self, programs):
        # ``programs(batch)``: the TileProgram of a launch of that many
        self._make = programs
        self.tp = programs(1)
        self.source = render_cuda(self.tp)
        self.launches = 0
        self._programs = {1: self.tp}
        self._sources: dict = {(id(self.tp), False): self.source}
        self._libs: dict = {}

    def program(self, batch: int = 1) -> TileProgram:
        """The tile program of a launch of ``batch`` examples: ``tp``
        unless the chooser gives that batch another geometry (one programs
        share while their geometries are equal)."""
        tp = self._programs.get(batch)
        if tp is None:
            tp = self._make(batch)
            tp = next((p for p in self._programs.values()
                       if p.geometry == tp.geometry), tp)
            self._programs[batch] = tp
        return tp

    def source_for(self, batch: int = 1, summed: bool = False) -> str:
        """The source a launch of ``batch`` examples (``summed``: of
        :meth:`apply_sum`) runs."""
        tp = self.program(batch)
        src = self._sources.get((id(tp), summed))
        if src is None:
            src = self._sources[id(tp), summed] = render_cuda(tp, summed)
        return src

    def apply(self, env: Mapping) -> dict:
        ins = [env[o.name] for o in self.tp.operands]
        if all(t.device.type == "cpu" for t in ins):
            return emulate(self.tp, env)
        return self._launch(env, ins, None)

    __call__ = apply

    def apply_batch(self, env: Mapping) -> dict:
        ins = [env[o.name] for o in self.tp.operands]
        batch = ins[0].shape[0]
        if all(t.device.type == "cpu" for t in ins):
            return self._emulate_batch(env, batch, False)
        return self._launch(env, ins, batch)

    def apply_sum(self, env: Mapping, batched: bool = False) -> dict:
        """Each output's partial sums, one per block of the grid: ``{name:
        (n_tiles,)}`` (``(B, n_tiles)`` when ``batched``: every env entry
        carries a leading batch axis) in float64, whose sum is the
        output's: the emulator's summed march on the CPU, else the summed
        kernel."""
        ins = [env[o.name] for o in self.tp.operands]
        batch = ins[0].shape[0] if batched else None
        if all(t.device.type == "cpu" for t in ins):
            if batch is None:
                return emulate(self.tp, env, summed=True)
            return self._emulate_batch(env, batch, True)
        return self._launch(env, ins, batch, summed=True)

    def _emulate_batch(self, env: Mapping, batch: int, summed: bool) -> dict:
        """The emulator per example, at the batch's tile program."""
        tp = self.program(batch)
        outs = [emulate(tp, {k: v[b] for k, v in env.items()}, summed)
                for b in range(batch)]
        return {o.name: torch.stack([out[o.name] for out in outs])
                for o in tp.outputs}

    def _launch(self, env: Mapping, ins: list, batch,
                summed: bool = False) -> dict:
        """Launch on the operands' card; ``batch`` None for one example."""
        tp = self.program(batch or 1)
        lead = () if batch is None else (batch,)
        dev = ins[0].device
        kd = KERNEL_DTYPES[tp.dtype]
        dt, acc = _torch_dtype(tp.dtype), _torch_dtype(kd.compute)
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
        src = self.source_for(batch or 1, summed)
        lib = self._libs.get(src)
        if lib is None:
            from ..kernels.build import load

            lib = self._libs[src] = load(src, _SYMBOLS)
        in_elems, out_elems, n_sc = tp.example_elems
        out_dt, out_width = dt, kd.width
        if summed:  # (batch, n_tiles) partials in float64
            out_elems = (tp.geometry.n_tiles,) * len(tp.outputs)
            out_dt, out_width = torch.float64, 8
        # the launcher's runtime calls act on the thread's current device
        with torch.cuda.device(dev):
            scal = None
            if n_sc:  # (B, n_scalars), or (n_scalars,) for one example
                scal = torch.stack([env[nm].to(device=dev, dtype=acc)
                                    for nm in tp.scalars], dim=-1)
            outs = [torch.empty(lead + ((n,) if summed else o.shape),
                                dtype=out_dt, device=dev)
                    for o, n in zip(tp.outputs, out_elems)]
            in_base = [t.data_ptr() for t in ins]
            out_base = [t.data_ptr() for t in outs]
            stream = torch.cuda.current_stream(dev).cuda_stream
            for first, count in batch_chunks(batch or 1):
                in_ptrs = (ctypes.c_void_p * len(ins))(
                    *chunk_pointers(in_base, in_elems, kd.width, first))
                out_ptrs = (ctypes.c_void_p * len(outs))(
                    *chunk_pointers(out_base, out_elems, out_width, first))
                sc_ptr = None if scal is None else chunk_pointers(
                    [scal.data_ptr()], [n_sc], scal.element_size(), first)[0]
                rc = lib.race_stencil_launch(
                    list(KERNEL_DTYPES).index(tp.dtype), in_ptrs, out_ptrs,
                    sc_ptr, count, stream)
                if rc != 0:
                    msg = lib.race_stencil_error(rc).decode()
                    raise RuntimeError(f"race stencil kernel launch failed: "
                                       f"CUDA error {rc} ({msg})")
                self.launches += 1
        if summed:
            return {o.name: t for o, t in zip(tp.outputs, outs)}
        return {o.name: t.to(_torch_dtype(o.dtype))
                for o, t in zip(tp.outputs, outs)}


def specialize_stencil(plan: Plan, shapes: Mapping, dtypes: Mapping,
                       block_rows: int = 0, block_cols: int = 0,
                       block_inner: int = 0) -> LoweredStencil:
    """Build the kernel's wrapper for one environment signature (the CUDA
    source is rendered here and compiled at the first launch on a card)."""
    return LoweredStencil(lambda batch: tile_program(
        plan, shapes, dtypes, block_rows, block_cols, block_inner, batch))
