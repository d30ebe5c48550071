"""Candidate-space enumeration for the autotuner of the PyTorch port.

Port of ``repro/tuning/space.py``.  The space for one program and
environment signature is

    reassociate ∈ {0, 3, 4}            (the levels the repo implements)
  × backend     ∈ {torch} ∪ {hopper if the probe passes for the plan and
                   the env's dtypes}
  × blocks      ∈ a small per-plan grid of (block_rows, block_cols,
                   block_inner) overrides of K1's tile chooser

The block fields keep the meaning they have in
:mod:`repro_torch.lowering.blocks`: ``block_rows`` sets level 1,
``block_cols`` levels 2..m-1, ``block_inner`` level m; on the stream level
an override sets the segment length, elsewhere the plane tile.  **0 means
"the chooser decides"**, so ``(0, 0, 0)`` is the chooser's own tile and
is always in the grid.  The other points are drawn from what
``chip_smoke.py --tile-sweep`` measured on the H100 (``PERF.md``): plane
tiles of 32×16, 64×16 and 16×64 for 3-D plans, row tiles of 512 and 2048
for 2-D plans, and half the chooser's segment where the stream level is
long.  A point the chooser cannot honour (a tile past its level's extent
rounded up to a power of two, rings over the shared memory of a block) is measured as an
``error`` candidate, never a crash (:func:`blocks_refusal`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Mapping, Optional, Sequence

from ..core.backend import probe_hopper
from ..core.depgraph import Plan

#: the reassociation strategies the repo implements (paper Section 7.1)
REASSOCIATE_LEVELS = (0, 3, 4)

#: representative serving batch sizes for batch-aware tuning: the batched
#: executor (one K1 launch with the batch on the grid) has other economics
#: than the per-call path, so the tuner measures these sizes separately and
#: the serving runtime picks the nearest recorded one at dispatch time
DEFAULT_BATCH_SIZES = (2, 8, 32)

#: plane tiles added for 3-D plans, as (lower plane level, higher plane
#: level): the ``--tile-sweep`` points that came within reach of the
#: chooser's 32×32 (64×16 beat it on poisson)
PLANE_TILES_3D = ((32, 16), (64, 16), (16, 64))
#: row tiles added for 2-D plans (the plane is one level)
ROW_TILES_2D = (512, 2048)
#: a stream level at least this long gets a shorter-segment candidate
LONG_STREAM = 256


def representative_batch_sizes(quick: bool = False) -> tuple:
    """The batch sizes a batch-aware search measures (one in quick mode)."""
    return (8,) if quick else DEFAULT_BATCH_SIZES


@dataclass(frozen=True)
class Config:
    """One point of the search space (hashable; the tuner's unit of work)."""

    reassociate: int
    backend: str  # "torch" | "hopper"
    block_rows: int = 0
    block_cols: int = 0
    block_inner: int = 0

    def describe(self) -> str:
        if self.backend != "hopper":
            return f"r{self.reassociate}/{self.backend}"
        blocks = (self.block_rows, self.block_cols, self.block_inner)
        if not any(blocks):
            return f"r{self.reassociate}/hopper[chooser]"
        return (f"r{self.reassociate}/hopper["
                + "x".join(str(b) if b else "-" for b in blocks) + "]")

    def as_dict(self) -> dict:
        return dict(reassociate=self.reassociate, backend=self.backend,
                    block_rows=self.block_rows, block_cols=self.block_cols,
                    block_inner=self.block_inner)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Config":
        """The config of a stored choice; block fields absent mean the
        chooser (0), as does a level absent (a plan record's choice is
        read for its backend and blocks only)."""
        return cls(reassociate=int(d.get("reassociate", 0)),
                   backend=str(d["backend"]),
                   block_rows=int(d.get("block_rows", 0)),
                   block_cols=int(d.get("block_cols", 0)),
                   block_inner=int(d.get("block_inner", 0)))


def _extents(plan: Plan) -> list:
    ranges = plan.program.ranges()
    return [ranges[l][1] - ranges[l][0] + 1
            for l in range(1, plan.program.depth + 1)]


def _as_blocks(m: int, per_level: Mapping[int, int]) -> Optional[tuple]:
    """``(block_rows, block_cols, block_inner)`` setting each level of
    ``per_level`` (levels 2..m-1 share ``block_cols``: None where two of
    them would need different values)."""
    rows = per_level.get(1, 0)
    inner = per_level.get(m, 0) if m > 1 else 0
    cols = {per_level[l] for l in range(2, m) if l in per_level}
    if len(cols) > 1:
        return None
    return (rows, cols.pop() if cols else 0, inner)


def block_grid(plan: Plan, quick: bool = False,
               itemsize: int = 4) -> List[tuple]:
    """The per-plan grid of ``(block_rows, block_cols, block_inner)``.

    Always holds ``(0, 0, 0)``, the chooser's tile.  For a 3-D plan it adds
    the plane tiles of :data:`PLANE_TILES_3D` (in quick mode the first
    only), for a 2-D plan the row tiles of :data:`ROW_TILES_2D`, and, where
    the stream level spans at least :data:`LONG_STREAM` points (not in quick
    mode), the chooser's plane tile with half its segment.  Points are not
    checked against the extents here: the measurement reports those it
    cannot honour."""
    from ..lowering.blocks import choose_tile, schedule

    m = plan.program.depth
    grid = [(0, 0, 0)]
    if m not in (2, 3):
        return grid
    s = schedule(plan).s_level
    plane = [l for l in range(1, m + 1) if l != s]
    if m == 3:
        tiles = PLANE_TILES_3D[:1] if quick else PLANE_TILES_3D
        points = [dict(zip(plane, t)) for t in tiles]
    else:
        points = [{plane[0]: t} for t in ROW_TILES_2D[:1 if quick else 2]]
    if s and not quick and _extents(plan)[s - 1] >= LONG_STREAM:
        try:
            seg = choose_tile(plan, itemsize)[0][s - 1]
        except ValueError:  # refused: the measurement reports it
            seg = 0
        if seg >= 2:
            points.append({s: seg // 2})
    for p in points:
        b = _as_blocks(m, p)
        if b is not None and b not in grid:
            grid.append(b)
    return grid


def blocks_refusal(plan: Plan, config: Config) -> Optional[str]:
    """Why K1's chooser cannot honour ``config``'s block overrides on
    ``plan`` without building anything, or None: a block larger than the
    largest the chooser takes on its level (its extent rounded up to a
    power of two), ``"tile-extent: ..."``.  The shared-memory refusal
    (``hopper-smem``) comes from the chooser itself when the executor is
    specialized."""
    if config.backend != "hopper":
        return None
    from ..lowering.blocks import _overrides, _pow2_ceil

    m = plan.program.depth
    ext = _extents(plan)
    fixed = _overrides(m, config.block_rows, config.block_cols,
                       config.block_inner)
    for l, v in sorted(fixed.items()):
        if v < 0 or v > _pow2_ceil(ext[l - 1]):
            return (f"tile-extent: block {v} on level {l} exceeds its "
                    f"extent {ext[l - 1]}")
    return None


def candidate_configs(plans: Mapping[int, Plan],
                      backends: Optional[Sequence[str]] = None,
                      grid: Optional[Iterable[tuple]] = None,
                      quick: bool = False,
                      sig: tuple = ()) -> List[Config]:
    """Enumerate every (reassociate level, backend, blocks) candidate.

    ``plans`` maps each reassociation level to its finalized plan.
    ``"torch"`` is always eligible; ``"hopper"`` only where
    :func:`~repro_torch.core.backend.probe_hopper` passes *for that level's
    plan and the dtypes its operands have in the env signature* ``sig``
    (mixed and integer dtypes are refused, ``hopper-dtype``).  ``backends`` restricts
    the set; ``grid`` overrides the per-plan block grid."""
    from ..core.executor import operand_dtypes
    from ..lowering.emit import KERNEL_DTYPES

    allowed = tuple(backends) if backends is not None else ("torch",
                                                            "hopper")
    grid = list(grid) if grid is not None else None
    out: List[Config] = []
    for lvl in sorted(plans):
        plan = plans[lvl]
        if "torch" in allowed:
            out.append(Config(lvl, "torch"))
        base = operand_dtypes(plan, sig)
        itemsize = max((KERNEL_DTYPES[d].shared if d in KERNEL_DTYPES
                        else 8 for d in base), default=8)
        if "hopper" in allowed and probe_hopper(plan, base).eligible:
            for br, bc, bi in (grid if grid is not None
                               else block_grid(plan, quick, itemsize)):
                out.append(Config(lvl, "hopper", br, bc, bi))
    return out
