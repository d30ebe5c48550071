"""Launch geometry of the Hopper stencil kernel.

Port of the role ``repro/lowering/blocks.py:build_layout`` plays for the
Pallas kernel, rethought for the card.  The reference's layout was shaped by
BlockSpec: a level-major iteration space, the innermost level full width,
three halo blocks per window operand and a refusal when the halo spread
exceeds a block.  None of that carries over:

  * one thread block computes one output tile; every level is tiled, the
    innermost too (a full-width innermost level of a 512-point grid does not
    fit in shared memory);
  * the tile's fastest (x) level is the loop level that indexes the arrays'
    contiguous last dimension — level 1 for the registry's Fortran-ordered
    3-D cases, not the innermost loop — and gets at least 32 points where the
    extent allows, so a warp's loads coalesce;
  * the tile is the largest power-of-two shape (up to ``MAX_TILE_POINTS``)
    whose aux footprint ``Σ_aux Π_l (tile_l + 2·ext_l) · itemsize`` fits
    ``SMEM_BUDGET``; a plan whose aux tiles overflow ``SMEM_LIMIT`` even at a
    one-point tile is refused with ``hopper-smem``;
  * halos are read straight from device memory with guarded loads, so there
    is no halo-spread limit;
  * the grid is flat: one block per tile, the x-level's tiles fastest, so any
    nest depth (the registry has 1 to 4) fits CUDA's grid.

``block_rows`` / ``block_cols`` / ``block_inner`` keep the reference's
meaning (level 1, levels 2..m-1, level m; a 1-D nest takes ``block_inner``
or ``block_rows``) and override the chooser for the levels they name.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod

from .facts import R_HOPPER_SMEM, FallbackReason, LoweringError

#: bytes of shared memory one block can have on Hopper (dynamic, opt-in)
SMEM_LIMIT = 232448
#: the chooser's target: at most half the SM's 228 KB, so two blocks fit
SMEM_BUDGET = 112 * 1024
#: largest tile the chooser grows to (points); 8 per thread at 256 threads
MAX_TILE_POINTS = 2048
#: the x-level's tile when its extent allows: one warp of coalesced loads
X_MIN = 32
#: threads per block (at most)
THREADS = 256


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def aux_footprint(plan, ext: dict, tile: tuple) -> int:
    """Shared-memory elements the plan's aux tiles take at ``tile``."""
    return sum(prod(tile[l - 1] + 2 * ext[a.name][l - 1] for l in a.levels)
               for a in plan.aux_order)


def x_level(plan, analysis) -> int:
    """The loop level that indexes the contiguous (last) array dimension,
    by vote over the base arrays and the outputs (outputs break ties)."""
    votes: dict = {}
    for info in analysis.arrays.values():
        if info.dims and info.dims[-1]:
            votes[info.dims[-1]] = votes.get(info.dims[-1], 0) + 1
    out_level = plan.body[0].lhs.subs[-1].s
    for st in plan.body:
        l = st.lhs.subs[-1].s
        votes[l] = votes.get(l, 0) + 1
    return max(votes, key=lambda l: (votes[l], l == out_level, -l))


@dataclass(frozen=True)
class LaunchGeometry:
    """Shape-specialized launch of one plan: everything the renderer and
    the emulator share."""

    m: int
    lo: tuple  # per-level statement lower bound
    hi: tuple  # per-level statement upper bound
    tile: tuple  # per-level tile size
    x_level: int
    order: tuple  # levels, fastest first (x-level, then innermost outward)
    nb: tuple  # per-level tile count
    threads: int

    @property
    def extents(self) -> tuple:
        return tuple(h - l + 1 for l, h in zip(self.lo, self.hi))

    @property
    def n_tiles(self) -> int:
        return prod(self.nb)


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


def choose_tile(plan, analysis, itemsize: int, block_rows: int = 0,
                block_cols: int = 0, block_inner: int = 0,
                budget: int = SMEM_BUDGET) -> tuple:
    """Per-level tile sizes for one plan (see the module docstring)."""
    m = analysis.depth
    ranges = plan.program.ranges()
    cap = {l: _pow2_ceil(ranges[l][1] - ranges[l][0] + 1)
           for l in range(1, m + 1)}
    fixed = _overrides(m, block_rows, block_cols, block_inner)
    xl = x_level(plan, analysis)
    tile = {l: fixed.get(l, 1) for l in range(1, m + 1)}
    if xl not in fixed:
        tile[xl] = min(X_MIN, cap[xl])

    def smem(t: dict) -> int:
        return aux_footprint(plan, analysis.ext,
                             tuple(t[l] for l in range(1, m + 1))) * itemsize

    while xl not in fixed and tile[xl] > 1 and smem(tile) > budget:
        tile[xl] //= 2
    if smem(tile) > SMEM_LIMIT:
        raise LoweringError((FallbackReason(
            R_HOPPER_SMEM,
            f"aux tiles need {smem(tile)} B of shared memory at tile "
            f"{tuple(tile.values())}, over the {SMEM_LIMIT} B a block can "
            f"have"),))
    def double(l: int) -> bool:
        if prod(tile.values()) * 2 > MAX_TILE_POINTS or tile[l] >= cap[l]:
            return False
        tile[l] *= 2
        if smem(tile) > budget:
            tile[l] //= 2
            return False
        return True

    # grow the other levels in turn, innermost first; then the x-level
    others = [l for l in range(m, 0, -1) if l != xl and l not in fixed]
    while any([double(l) for l in others]):
        pass
    while xl not in fixed and double(xl):
        pass
    return tuple(tile[l] for l in range(1, m + 1))


def build_geometry(plan, analysis, itemsize: int, block_rows: int = 0,
                   block_cols: int = 0, block_inner: int = 0
                   ) -> LaunchGeometry:
    m = analysis.depth
    ranges = plan.program.ranges()
    lo = tuple(ranges[l][0] for l in range(1, m + 1))
    hi = tuple(ranges[l][1] for l in range(1, m + 1))
    tile = choose_tile(plan, analysis, itemsize, block_rows, block_cols,
                       block_inner)
    xl = x_level(plan, analysis)
    order = (xl,) + tuple(l for l in range(m, 0, -1) if l != xl)
    nb = tuple(-(-(h - l + 1) // t) for l, h, t in zip(lo, hi, tile))
    threads = min(THREADS, max(32, _pow2_ceil(prod(tile))))
    return LaunchGeometry(m=m, lo=lo, hi=hi, tile=tile, x_level=xl,
                          order=order, nb=nb, threads=threads)
