"""Lowering of RACE plans onto the hand-written Hopper stencil kernel.

  * :mod:`.facts`    — structured fallback reasons and lowering facts shared
    with the capability probe (own copy of the reference's, plus the codes
    of what Hopper refuses);
  * :mod:`.geometry` — plan analysis: eligibility and per-aux tile
    extensions (own copy of the reference's), plus the kernel's own view:
    :func:`~.geometry.kernel_analysis` and the exact one-sided aux ranges;
  * :mod:`.blocks`   — the kernel's launch geometry and march schedule:
    stream level, plane tile, segments, rings, shared-memory footprint;
  * :mod:`.emit`     — the per-plan tile program, its CUDA C++ rendering,
    its CPU emulator and :class:`~.emit.LoweredStencil`, the wrapper.
"""
from .facts import (FALLBACK_CODES, R_HOPPER_DTYPE, R_HOPPER_SMEM,
                    FallbackReason, LoweringError, LoweringFact)
from .geometry import LoweringAnalysis, analyze_plan

__all__ = ["FALLBACK_CODES", "R_HOPPER_DTYPE", "R_HOPPER_SMEM",
           "FallbackReason", "LoweringError", "LoweringFact",
           "LoweringAnalysis", "analyze_plan"]
