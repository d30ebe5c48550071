"""Launch geometry and schedule of the Hopper stencil kernel.

Port of the role ``repro/lowering/blocks.py:build_layout`` plays for the
Pallas kernel, rethought for the card.  The reference's layout was shaped by
BlockSpec: a level-major iteration space, the innermost level full width,
three halo blocks per window operand and a refusal when the halo spread
exceeds a block.  None of that carries over.  The kernel streams (2.5-D):

  * the **stream level** is the loop level that indexes the operands' and
    outputs' outermost array dimension (by vote, as the x-level is), so that
    one plane of it is a contiguous slab: level 3 for the registry's
    Fortran-ordered 3-D cases.  It is never a level some array or output is
    contiguous in, where another can be had (a plane across an array's
    contiguous dimension would read or write it one element per row).  A
    depth-1 nest has none (a march of one step);
  * a block owns a **plane tile** of the other levels and a **segment** of
    the stream level, and marches along the segment one plane per step;
  * each aux that covers the stream level keeps a **ring** of planes in
    shared memory: at every step the block evaluates each aux's leading
    plane, in topological order, then one output plane, so every aux plane
    is evaluated once per step.  An aux that does not cover the stream
    level is one box per block, evaluated before the march;
  * each operand read only at unit positive coefficients is **staged**: one
    plane window (the plane tile plus its one-sided halo) per step, into a
    ring of its own with one slot more than its reads span, so the next
    step's plane loads while this step computes (double buffering);
  * the aux of a step are evaluated in **phases**, one barrier after each:
    an aux's phase is one more than that of every aux whose plane of the
    same step it reads (older planes were written before the step's first
    barrier);
  * boxes are the **exact one-sided ranges** of
    :func:`~.geometry.aux_ranges`, not the symmetric ``±ext``; a ring holds
    the planes from its lead back to the oldest plane any consumer reads at
    a step, and is first written at the step its first needed plane leads;
  * a segment starts with a warm-up of ``-k0`` steps that fills the rings;
    its length is chosen so that the grid holds at least
    ``TARGET_BLOCKS`` blocks where the extent allows, at no fewer than
    ``SEG_PER_WARMUP`` warm-ups or, where those leave a launch (its batch
    included) under ``SHORT_GRID`` blocks (the LM mixer's 516 planes),
    ``SHORT_SEGMENT`` planes;
  * the plane tile is the power-of-two shape (up to ``MAX_PLANE_POINTS``
    points, each level an array or output is contiguous in spanning a
    128-byte line where the extent allows)
    whose rings fit ``SMEM_BUDGET`` with the fewest aux plane elements per
    output point (the sweeps in ``PERF.md`` set this rule: larger planes
    and smaller halos won on every cell); a plan whose aux rings overflow
    ``SMEM_LIMIT`` even at a one-point plane tile is refused with
    ``hopper-smem``; operands whose windows do not fit are read from
    device memory instead of staged;
  * the grid is flat: one block per (plane tile, segment), the x-level's
    tiles fastest and the segments slowest, so any nest depth (the registry
    has 1 to 4) fits CUDA's grid.

``block_rows`` / ``block_cols`` / ``block_inner`` keep the reference's
meaning (level 1, levels 2..m-1, level m; a 1-D nest takes ``block_inner``
or ``block_rows``) and override the chooser for the levels they name; on
the stream level the override sets the segment length.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from math import prod

from ..core.ir import expr_refs
from .facts import R_HOPPER_SMEM, FallbackReason, LoweringError
from .geometry import (K_WINDOW, aux_ranges, aux_shift, kernel_analysis,
                       kernel_memo)

#: bytes of shared memory one block can have on Hopper (dynamic, opt-in)
SMEM_LIMIT = 232448
#: the chooser's target: at most half the SM's 228 KB, so two blocks fit
SMEM_BUDGET = 112 * 1024
#: largest plane tile the chooser takes (points): four per thread
MAX_PLANE_POINTS = 1024
#: bytes the x-level's tile spans where its extent allows: one cache line
LINE_BYTES = 128
#: threads per block (at most)
THREADS = 256
#: blocks the segment length aims for: eight per SM of the H100's 132
TARGET_BLOCKS = 8 * 132
#: shortest segment the chooser makes, in multiples of the warm-up
SEG_PER_WARMUP = 8
#: a launch's grid is short under this many blocks at SEG_PER_WARMUP
#: warm-ups (two per SM): then the march's latency bounds a block, not the
#: warm-ups' extra work (``PERF.md``, on an H100: a batch of 32 j3d27pt
#: n=64 examples, 384 blocks, lost 1.17-1.24x at short segments; the
#: mixer's plans, 32-224 blocks, won 1.16-2.4x)
SHORT_GRID = 2 * 132
#: shortest segment (planes, and at least one warm-up) of a short grid
#: (``PERF.md``'s mixer sweep: 4 to 8 planes were fastest at 516 planes)
SHORT_SEGMENT = 4
#: context key of the body in :attr:`Schedule.reads`
BODY = -1


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _vote(plan, analysis, pick) -> dict:
    votes: dict = {}
    for info in analysis.arrays.values():
        if info.dims and pick(info.dims):
            votes[pick(info.dims)] = votes.get(pick(info.dims), 0) + 1
    for st in plan.body:
        l = pick(tuple(s.s for s in st.lhs.subs))
        votes[l] = votes.get(l, 0) + 1
    return votes


def x_level(plan, analysis) -> int:
    """The loop level that indexes the contiguous (last) array dimension,
    by vote over the base arrays and the outputs (outputs break ties)."""
    votes = _vote(plan, analysis, lambda dims: dims[-1])
    out_level = plan.body[0].lhs.subs[-1].s
    return max(votes, key=lambda l: (votes[l], l == out_level, -l))


def contiguous_levels(plan, analysis) -> tuple:
    """The levels that index some base array's or output's last (contiguous)
    dimension."""
    return tuple(sorted(_vote(plan, analysis, lambda dims: dims[-1])))


def stream_level(plan, analysis, xl: int) -> int:
    """The level the kernel marches along (0 for a depth-1 nest): the one
    that indexes the outermost array dimension, by vote over the base arrays
    and the outputs, never the x-level."""
    m = analysis.depth
    if m == 1:
        return 0
    votes = _vote(plan, analysis, lambda dims: dims[0])
    contiguous = contiguous_levels(plan, analysis)
    out_level = plan.body[0].lhs.subs[0].s
    levels = [l for l in range(1, m + 1) if l != xl]
    return max([l for l in levels if l not in contiguous] or levels,
               key=lambda l: (votes.get(l, 0), l == out_level, l))


@dataclass(frozen=True)
class Ring:
    """One aux or staged operand in shared memory.

    Its box on each level is ``[lo, hi]`` relative to the block's tile
    origin (for an operand: in array index minus the origin) widened by the
    tile; along the stream level it is a ring of ``depth`` planes, the
    plane written at step ``k`` being the block's plane ``k + lead``."""

    name: str
    operand: bool  # a staged base array (else an aux)
    levels: tuple  # covered loop levels, ascending
    lo: tuple  # per level: first offset of the box (0 where uncovered)
    hi: tuple  # per level: last offset of the box
    streamed: bool  # covers the stream level: a ring of planes
    depth: int  # planes kept (1 for a box evaluated once per block)
    lead: int  # plane written at step k: k + lead
    start: int  # first step it is written at
    phase: int = 0  # barrier phase of a step (aux on a plane only)
    widths: tuple = ()  # per level box width in a plane (1: stream, uncovered)
    strides: tuple = ()  # per level element stride in a plane (0: not in it)
    offset: int = 0  # first element in shared memory

    @property
    def plane(self) -> int:
        return prod(self.widths)

    @property
    def size(self) -> int:
        return self.depth * self.plane


@dataclass(frozen=True)
class Read:
    """Where one shifted reference finds its value: ring ``ring``, the slot
    ``back`` planes behind the ring's lead, at the reading box's position
    plus ``offset`` on each level."""

    ring: int
    back: int
    offset: tuple  # per level (0 on the stream level and uncovered levels)


@dataclass(frozen=True)
class Schedule:
    """The march of one plan, independent of the tile: rings (aux in
    topological order, then staged operands) and the read of every ring
    reference, keyed by ``(context, ref)`` where the context is the reading
    aux's ring index or :data:`BODY`."""

    x_level: int
    s_level: int  # 0: no stream level
    contiguous: tuple  # levels some array or output is contiguous in
    rings: tuple
    reads: dict

    @property
    def k0(self) -> int:
        """First step of a segment (minus the warm-up)."""
        return min([0] + [r.start for r in self.rings if r.streamed])

    def plane_widths(self, ring: Ring, tile: dict) -> tuple:
        m = len(ring.lo)
        return tuple(tile[l] + ring.hi[l - 1] - ring.lo[l - 1]
                     if l in ring.levels and l != self.s_level else 1
                     for l in range(1, m + 1))

    def footprint(self, tile: dict) -> int:
        """Shared-memory elements of the rings at a plane tile."""
        return sum(r.depth * prod(self.plane_widths(r, tile))
                   for r in self.rings)


def schedule(plan, stage: bool = True) -> Schedule:
    """The rings and reads of a plan (as
    :func:`~.geometry.kernel_analysis` sees it); ``stage=False`` reads
    every operand from device memory."""
    analysis = kernel_analysis(plan)
    m = analysis.depth
    xl = x_level(plan, analysis)
    s = stream_level(plan, analysis, xl)
    ranges = aux_ranges(plan)
    aux = [a for a in plan.aux_order if a.levels]
    index = {a.name: k for k, a in enumerate(aux)}
    staged = sorted(
        nm for nm, info in analysis.arrays.items()
        if stage and s and info.kind == K_WINDOW and s in info.levels
        and all(info.coefs[l] == 1 and info.signs[l] > 0
                for l in info.levels))
    index.update({nm: len(aux) + k for k, nm in enumerate(staged)})
    zero = (0,) * m

    # contexts: (key, expr, lo, hi, lead) — the body reads at (0, ..., 0)
    ctxs = [(k, plan.aux_exprs[a.name], tuple(r[0] for r in ranges[a.name]),
             tuple(r[1] for r in ranges[a.name]),
             ranges[a.name][s - 1][1] if s in a.levels else 0)
            for k, a in enumerate(aux)]
    ctxs += [(BODY, st.rhs, zero, zero, 0) for st in plan.body]

    def refs():
        """Every (context, ring reference) with the context's box."""
        for key, expr, lo, hi, lead in ctxs:
            for r in expr_refs(expr):
                if r.subs and r.name in index:
                    yield key, r, lo, hi, lead

    # operand windows: the hull of every context's range moved by each
    # reference's offset (unit coefficients: index minus the origin); the
    # oldest plane of each ring that some context reads at a step
    win: dict = {}
    oldest: dict = {}
    for key, r, lo, hi, lead in refs():
        sh = aux_shift(r)
        if index[r.name] >= len(aux):
            box = win.setdefault(r.name, {})
            for l, off in sh.items():
                cur = box.get(l, (lo[l - 1] + off, hi[l - 1] + off))
                box[l] = (min(cur[0], lo[l - 1] + off),
                          max(cur[1], hi[l - 1] + off))
        if s in sh:
            oldest[r.name] = min(oldest.get(r.name, lead + sh[s]),
                                 lead + sh[s])

    rings = []
    for a in aux:
        rg = ranges[a.name]
        lo, hi = tuple(r[0] for r in rg), tuple(r[1] for r in rg)
        levels = tuple(sorted(a.levels))
        if s in a.levels:
            rings.append(Ring(a.name, False, levels, lo, hi, True,
                              hi[s - 1] - oldest.get(a.name, hi[s - 1]) + 1,
                              hi[s - 1],
                              lo[s - 1] - hi[s - 1]))
        else:
            rings.append(Ring(a.name, False, levels, lo, hi, False, 1, 0, 0))
    for nm in staged:
        box = win[nm]
        levels = tuple(sorted(box))
        lo = tuple(box[l][0] if l in box else 0 for l in range(1, m + 1))
        hi = tuple(box[l][1] if l in box else 0 for l in range(1, m + 1))
        # one slot more than the reads span: the next step's load is in
        # flight while this step reads
        rings.append(Ring(nm, True, levels, lo, hi, True,
                          hi[s - 1] - oldest[nm] + 2, hi[s - 1],
                          lo[s - 1] - hi[s - 1]))

    reads = {}
    for key, r, lo, hi, lead in refs():
        ring = rings[index[r.name]]
        sh = aux_shift(r)
        off = tuple(lo[l - 1] + sh[l] - ring.lo[l - 1]
                    if l in sh and l != s else 0 for l in range(1, m + 1))
        back = ring.lead - (lead + sh[s]) if ring.streamed else 0
        reads[(key, r)] = Read(index[r.name], back, off)
    for k, a in enumerate(aux):
        if rings[k].streamed:
            rings[k] = replace(rings[k], phase=1 + max(
                [rings[rd.ring].phase for (key, _), rd in reads.items()
                 if key == k and rd.ring < len(aux)
                 and rings[rd.ring].streamed and rd.back == 0],
                default=-1))
    return Schedule(xl, s, contiguous_levels(plan, analysis), tuple(rings),
                    reads)


@dataclass(frozen=True)
class LaunchGeometry:
    """Shape-specialized launch of one plan: everything the renderer and
    the emulator share."""

    m: int
    lo: tuple  # per-level statement lower bound
    hi: tuple  # per-level statement upper bound
    tile: tuple  # per-level block extent (the segment on the stream level)
    x_level: int
    s_level: int  # 0: no stream level
    order: tuple  # plane levels, fastest first (the outputs' contiguous
                  # level, the x-level, then inner out)
    nb: tuple  # per-level block count
    threads: int
    rings: tuple  # Ring, laid out in shared memory
    reads: dict  # (context, Ref) -> Read
    k0: int  # first step of a segment (-warm-up)

    @property
    def extents(self) -> tuple:
        return tuple(h - l + 1 for l, h in zip(self.lo, self.hi))

    @property
    def n_tiles(self) -> int:
        return prod(self.nb)

    @property
    def seg(self) -> int:
        """Output planes per block (1 without a stream level)."""
        return self.tile[self.s_level - 1] if self.s_level else 1

    @property
    def plane_points(self) -> int:
        return prod(self.tile[l - 1] for l in self.order)

    @property
    def smem_elems(self) -> int:
        return sum(r.size for r in self.rings)


def _overrides(m: int, block_rows: int, block_cols: int,
               block_inner: int) -> dict:
    if m == 1:
        v = block_inner or block_rows
        return {1: v} if v else {}
    fixed = {}
    if block_rows:
        fixed[1] = block_rows
    if block_cols:
        fixed.update({l: block_cols for l in range(2, m)})
    if block_inner:
        fixed[m] = block_inner
    return fixed


def _refuse(sched: Schedule, tile: dict, itemsize: int) -> LoweringError:
    n = sched.footprint(tile) * itemsize
    return LoweringError((FallbackReason(
        R_HOPPER_SMEM,
        f"aux rings need {n} B of shared memory at plane tile "
        f"{tuple(tile.values())}, over the {SMEM_LIMIT} B a block can "
        f"have"),))


def choose_tile(plan, itemsize: int, block_rows: int = 0,
                block_cols: int = 0, block_inner: int = 0,
                budget: int = SMEM_BUDGET, batch: int = 1) -> tuple:
    """``(tile, schedule)``: the per-level block extent (the segment length
    on the stream level, :func:`segment_length` for a launch of ``batch``
    examples) and the schedule it was sized for.

    The plane tile is, among power-of-two shapes of at most
    ``MAX_PLANE_POINTS`` points whose rings fit ``budget``, the one with the
    fewest aux plane elements per output point, then the fewest staged
    operand elements, then the most points, then the widest x-level, with
    each plane level that an array or output is contiguous in (the x-level
    among them) spanning a ``LINE_BYTES`` line where the extent allows.
    When no shape fits with the operands staged, they are read from device
    memory; when none fits at all, the one-point tile is taken up to
    ``SMEM_LIMIT`` and refused beyond it.  Memoized in
    :func:`~.geometry.kernel_memo`."""
    memo = kernel_memo(plan)
    key = ("tile", itemsize, block_rows, block_cols, block_inner, budget,
           batch)
    if key not in memo:
        memo[key] = _choose_tile(plan, itemsize, block_rows, block_cols,
                                 block_inner, budget, batch)
    return memo[key]


def _choose_tile(plan, itemsize, block_rows, block_cols, block_inner,
                 budget, batch) -> tuple:
    m = plan.program.depth
    ranges = plan.program.ranges()
    extent = {l: ranges[l][1] - ranges[l][0] + 1 for l in range(1, m + 1)}
    cap = {l: _pow2_ceil(n) for l, n in extent.items()}
    fixed = _overrides(m, block_rows, block_cols, block_inner)
    for stage in (True, False):
        sched = schedule(plan, stage)
        xl, s = sched.x_level, sched.s_level
        plane = [l for l in range(1, m + 1) if l != s]
        lines = [l for l in sched.contiguous if l in plane]
        n_aux = sum(not r.operand for r in sched.rings)
        best = None
        for shape in itertools.product(*(
                [fixed[l]] if l in fixed else
                [1 << k for k in range(cap[l].bit_length())]
                for l in plane)):
            tile = dict(zip(plane, shape))
            points = prod(shape)
            if points > MAX_PLANE_POINTS and len(fixed) < len(plane):
                continue
            if sched.footprint(tile) * itemsize > budget:
                continue
            widths = [prod(sched.plane_widths(r, tile)) for r in sched.rings]
            short = sum(tile[l] < min(LINE_BYTES // itemsize, cap[l])
                        for l in lines)
            key = (short, sum(widths[:n_aux]) / points,
                   sum(widths[n_aux:]) / points, -points, -tile[xl])
            if best is None or key < best[0]:
                best = (key, tile)
        if best is not None:
            tile = best[1]
            break
    else:
        tile = {l: fixed.get(l, 1) for l in plane}
        if sched.footprint(tile) * itemsize > SMEM_LIMIT:
            raise _refuse(sched, tile, itemsize)
    if s:
        tile[s] = fixed.get(s) or segment_length(
            extent[s], prod(-(-extent[l] // tile[l]) for l in plane),
            -sched.k0, batch)
    return tuple(tile[l] for l in range(1, m + 1)), sched


def segment_length(extent: int, plane_tiles: int, warmup: int,
                   batch: int = 1) -> int:
    """Planes per segment: the whole extent, cut into as many equal
    segments as bring one example's grid to ``TARGET_BLOCKS`` blocks, none
    shorter than ``SEG_PER_WARMUP`` warm-ups (the warm-up's share of a
    segment's steps stays under 1/9) or, where that leaves the grid of a
    launch of ``batch`` examples under ``SHORT_GRID`` blocks (a short
    stream, run alone: the march, not the bytes, bounds a block), than
    ``SHORT_SEGMENT`` planes and one warm-up.  A batch that fills the card
    keeps the long segments: short ones cost the batched cells
    1.16-1.24x on an H100 (``PERF.md``)."""
    want = -(-TARGET_BLOCKS // plane_tiles)
    n_seg = max(1, min(want, extent // max(1, SEG_PER_WARMUP * warmup)))
    if n_seg < want and n_seg * plane_tiles * batch < SHORT_GRID:
        n_seg = max(1, min(want, extent // max(SHORT_SEGMENT, warmup)))
    return -(-extent // n_seg)


def build_geometry(plan, itemsize: int, block_rows: int = 0,
                   block_cols: int = 0, block_inner: int = 0,
                   batch: int = 1) -> LaunchGeometry:
    """The launch geometry of ``plan`` for launches of ``batch`` examples
    (the grid's second axis)."""
    m = plan.program.depth
    ranges = plan.program.ranges()
    lo = tuple(ranges[l][0] for l in range(1, m + 1))
    hi = tuple(ranges[l][1] for l in range(1, m + 1))
    tile, sched = choose_tile(plan, itemsize, block_rows, block_cols,
                              block_inner, batch=batch)
    xl, s = sched.x_level, sched.s_level
    # the level the outputs are contiguous in runs fastest in every box, so
    # that stores coalesce and shared memory is read along rows; operand
    # planes still load along their own contiguous level (emit._stage)
    wl = plan.body[0].lhs.subs[-1].s
    head = (wl, xl) if wl not in (xl, s) else (xl,)
    order = head + tuple(l for l in range(m, 0, -1)
                         if l not in head and l != s)
    tiles = dict(zip(range(1, m + 1), tile))
    rings, offset = [], 0
    for r in sched.rings:
        widths = sched.plane_widths(r, tiles)
        strides, acc = [0] * m, 1
        for l in order:
            if l in r.levels:
                strides[l - 1] = acc
                acc *= widths[l - 1]
        rings.append(replace(r, widths=widths, strides=tuple(strides),
                             offset=offset))
        offset += rings[-1].size
    nb = tuple(-(-(h - l + 1) // t) for l, h, t in zip(lo, hi, tile))
    if prod(nb) >= 2 ** 31:
        raise ValueError(f"grid of {prod(nb)} blocks is over CUDA's limit")
    plane_points = prod(tile[l - 1] for l in order)
    threads = min(THREADS, max(32, _pow2_ceil(plane_points)))
    return LaunchGeometry(m=m, lo=lo, hi=hi, tile=tile, x_level=xl,
                          s_level=s, order=order, nb=nb, threads=threads,
                          rings=tuple(rings), reads=sched.reads,
                          k0=sched.k0)
