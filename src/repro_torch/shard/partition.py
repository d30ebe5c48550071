"""Spatial partitioning of a plan's iteration box over a device mesh.

Port of ``repro/shard/partition.py``, the reference's pure analysis
copied: it reads the mesh duck-typed (``axis_names`` + ``shape[name]``,
as :class:`repro_torch.launch.mesh.Mesh` gives them), and produces
either a :class:`PartitionPlan` whose assignments the sharded executor
turns into per-shard index boxes, or structured
:class:`ShardRefusal` reasons — never a silent fallback, exactly like the
capability-probe vocabulary in :mod:`repro_torch.lowering.facts`.

Envelopes come from
:func:`repro_torch.lowering.geometry.analyze_program` — the *program's*
direct read offsets, not the plan's auxiliary-extended ones.
RACE preserves semantics, so every auxiliary value that influences an
interior output is a partial sum of original-program terms at the same
iteration point: the program envelope bounds the influencing reach exactly,
while the plan envelope adds rectangular range-propagation slop whose slab
positions hold values never consumed (the single-device evaluators already
run with program-sized arrays for the same reason).

The geometry is one-sided-by-construction.  A level ``l`` with range
``[lo, hi]`` (extent ``E``) split into ``P`` chunks of ``e = E / P`` gives
shard ``p`` the local iteration box ``[lo, lo + e - 1]``; an array whose
program offset envelope at ``l`` is ``[off_lo, off_hi]`` has its influencing
reads on ``[p·e + lo + off_lo, p·e + e - 1 + lo + off_hi]``.  Since
``lo + off_lo >= 0`` for every in-bounds single-device program (else the
*unsharded* baseline would already index below zero), the slab

    u[p·e : p·e + e + t],   t = max(0, lo + off_hi)

covers every influencing read — a right-halo of width ``t`` fetched from the
successor shard (or replicated global tail for the last shard), no left halo
ever.  Legality is exactly the points where that construction breaks:

* ``shard-geometry``      — the program has no offset envelopes at all
  (``analyze_program`` ineligible); nothing can be sized.
* ``shard-mirrored``      — a negative coefficient reads the level mirrored;
  a chunk's reads span the *whole* axis reversed, not a slab.
* ``shard-strided``       — ``|a| >= 2`` dilates reads beyond chunk-local.
* ``shard-gather``        — a gather-class array (repeated level / constant
  dim) references the level; gathers have no window form to slab.
* ``shard-envelope``      — ``lo + off_lo < 0``: a chunk would read left of
  its own slab start.
* ``shard-divisibility``  — the mesh axis size does not divide ``E``
  (the reference's ``models/sharding.py`` ``divides`` guard applied
  to grid extents; :func:`_divides` here is its copy).
* ``shard-halo-exceeds-chunk`` — ``t > e``: the halo spans more than the
  immediate neighbor, so one neighbour's slab cannot supply it.
* ``shard-no-axis``       — no mesh axis could be placed on any level.

Placement policy: mesh axes in declaration order each take the first
(ascending) unassigned shardable level that passes their size-dependent
checks.  Size-1 axes place like any other (their checks pass trivially), so
a single-device mesh exercises the full sharded machinery in-process.  An
axis that cannot place leaves informational refusals and the outputs are
replicated over it; the plan as a whole is refused (``ok=False``) only when
*no* axis places or the plan is geometry-ineligible.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..lowering.geometry import K_GATHER, K_WINDOW, analyze_program

#: stable shard-refusal codes (mirrors lowering/facts.py FALLBACK_CODES)
S_GEOMETRY = "shard-geometry"
S_MIRRORED = "shard-mirrored"
S_STRIDED = "shard-strided"
S_GATHER = "shard-gather"
S_ENVELOPE = "shard-envelope"
S_DIVISIBILITY = "shard-divisibility"
S_HALO = "shard-halo-exceeds-chunk"
S_NO_AXIS = "shard-no-axis"

SHARD_REFUSAL_CODES = frozenset({
    S_GEOMETRY, S_MIRRORED, S_STRIDED, S_GATHER, S_ENVELOPE,
    S_DIVISIBILITY, S_HALO, S_NO_AXIS,
})


@dataclass(frozen=True)
class ShardRefusal:
    """One structured reason a level (or the whole plan) cannot shard.

    ``level == 0`` marks plan-wide refusals (geometry, no-axis)."""

    code: str
    detail: str
    level: int = 0

    def __str__(self) -> str:
        return f"{self.code}: {self.detail}"


@dataclass(frozen=True)
class LevelVerdict:
    """Size-independent shardability of one grid level."""

    level: int
    shardable: bool
    lo: int
    extent: int
    halo: int  # max over arrays of max(0, lo + off_hi): right-slab width
    refusals: tuple  # ShardRefusal, empty when shardable


@dataclass(frozen=True)
class AxisAssignment:
    """One mesh axis placed on one grid level."""

    level: int
    mesh_axis: str
    shards: int
    lo: int
    extent: int  # global E
    chunk: int  # e = extent // shards: local iterations per shard
    halo: int  # t: right-halo width every slab along this level carries


@dataclass(frozen=True)
class PartitionPlan:
    """The partitioner's full answer for one (plan, mesh) pair."""

    ok: bool
    assignments: tuple  # AxisAssignment, in mesh-axis declaration order
    refusals: tuple  # every ShardRefusal hit (informational when ok)
    verdicts: tuple  # LevelVerdict per grid level (empty on S_GEOMETRY)
    mesh_axes: tuple  # ((axis name, size), ...) in declaration order

    def key(self) -> tuple:
        """Cache-key component: ((level, mesh axis, shards), ...)."""
        return tuple((a.level, a.mesh_axis, a.shards)
                     for a in self.assignments)

    @property
    def by_level(self) -> dict:
        return {a.level: a for a in self.assignments}

    def explain(self) -> str:
        if self.ok:
            placed = ", ".join(
                f"level {a.level} -> {a.mesh_axis}({a.shards}) "
                f"chunk {a.chunk} halo {a.halo}" for a in self.assignments)
            return f"sharded: {placed}"
        return "; ".join(str(r) for r in self.refusals)


def _level_verdicts(analysis, ranges) -> list:
    out = []
    for level in range(1, analysis.depth + 1):
        lo, hi = ranges[level]
        extent = hi - lo + 1
        refs: list = []
        halo = 0
        for nm in sorted(analysis.arrays):
            info = analysis.arrays[nm]
            if level not in info.levels:
                continue
            if info.kind == K_GATHER:
                refs.append(ShardRefusal(
                    S_GATHER,
                    f"gather-class array {nm} references level {level}; "
                    f"gathers have no window form to slab", level))
                continue
            assert info.kind == K_WINDOW
            bad = False
            if info.signs.get(level, 1) < 0:
                refs.append(ShardRefusal(
                    S_MIRRORED,
                    f"{nm} reads level {level} with a negative coefficient "
                    f"(mirrored-origin window spans the whole axis)", level))
                bad = True
            if abs(info.coefs.get(level, 1)) != 1:
                refs.append(ShardRefusal(
                    S_STRIDED,
                    f"{nm} reads level {level} with stride "
                    f"{info.coefs[level]}; strided reads dilate past the "
                    f"chunk", level))
                bad = True
            if bad:
                continue
            if lo + info.off_lo[level] < 0:
                refs.append(ShardRefusal(
                    S_ENVELOPE,
                    f"{nm} at level {level}: lo + off_lo = "
                    f"{lo + info.off_lo[level]} < 0 — a chunk would read "
                    f"left of its slab start", level))
            halo = max(halo, lo + info.off_hi[level])
        out.append(LevelVerdict(level, not refs, lo, extent,
                                max(halo, 0), tuple(refs)))
    return out


def _divides(mesh, dim: int, axis: str) -> bool:
    """True when ``dim`` is positive and ``axis``'s size divides it (the
    reference's ``models/sharding.py`` ``divides`` for one axis)."""
    return dim > 0 and dim % int(mesh.shape[axis]) == 0


def plan_partition(program, mesh) -> PartitionPlan:
    """Place the mesh's axes onto the program's shardable grid levels.

    ``program`` is the original :class:`~repro_torch.core.ir.Program`
    (shardability is a property of the computation's semantics, identical
    for every plan derived from it); ``mesh`` is any object with
    ``axis_names`` and a ``shape`` mapping (a
    :class:`~repro_torch.launch.mesh.Mesh` in practice).
    """
    mesh_axes = tuple((str(n), int(mesh.shape[n])) for n in mesh.axis_names)
    analysis = analyze_program(program)
    if not analysis.eligible:
        why = "; ".join(str(r) for r in analysis.reasons)
        return PartitionPlan(
            False, (), (ShardRefusal(
                S_GEOMETRY, f"program has no offset envelopes ({why})"),),
            (), mesh_axes)

    verdicts = _level_verdicts(analysis, program.ranges())
    refusals = [r for v in verdicts for r in v.refusals]
    assignments: list = []
    taken: set = set()
    for name, size in mesh_axes:
        placed = None
        for v in verdicts:
            if v.level in taken or not v.shardable:
                continue
            if not _divides(mesh, v.extent, name):
                refusals.append(ShardRefusal(
                    S_DIVISIBILITY,
                    f"mesh axis {name} (size {size}) does not divide "
                    f"level {v.level} extent {v.extent}", v.level))
                continue
            chunk = v.extent // size
            if v.halo > chunk:
                refusals.append(ShardRefusal(
                    S_HALO,
                    f"level {v.level} halo {v.halo} exceeds chunk {chunk} "
                    f"under mesh axis {name} (size {size}); one neighbour's "
                    f"slab cannot supply it", v.level))
                continue
            placed = AxisAssignment(v.level, name, size, v.lo, v.extent,
                                    chunk, v.halo)
            break
        if placed is None:
            continue
        assignments.append(placed)
        taken.add(placed.level)

    ok = bool(assignments)
    if not ok:
        refusals.append(ShardRefusal(
            S_NO_AXIS,
            f"no mesh axis ({', '.join(f'{n}={s}' for n, s in mesh_axes)}) "
            f"placeable on any of {analysis.depth} grid level(s)"))

    # dedupe, first-seen order (several refs can repeat a (code, detail))
    seen: set = set()
    uniq = []
    for r in refusals:
        k = (r.code, r.detail, r.level)
        if k not in seen:
            seen.add(k)
            uniq.append(r)
    return PartitionPlan(ok, tuple(assignments), tuple(uniq),
                         tuple(verdicts), mesh_axes)
