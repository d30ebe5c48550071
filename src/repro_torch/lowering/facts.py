"""Own copy of ``repro/lowering/facts.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

Structured lowering verdicts: fallback reasons, lowering facts, errors.

This module is the shared vocabulary between the capability probe
(``repro_torch.core.backend``) and the lowering engine (``repro_torch.lowering``): both
sides speak in the same ``(code, detail)`` pairs, so what the probe promises
and what the engine does can never drift apart — the probe literally calls
the engine's analysis (:func:`repro_torch.lowering.geometry.analyze_plan`).

Two kinds of verdicts share the shape:

  * **fallback reasons** — structural obstacles that keep a plan on the XLA
    evaluator path.  Since the dimension-generic engine landed these are the
    genuinely out-of-model programs only (malformed writes, zero/fractional
    subscripts, per-array inconsistencies, scalar-only data);
  * **lowering facts** — properties that *used to be* fallbacks but are now
    handled by a dedicated mechanism, reported so callers can see which
    machinery a plan engages: 1-D / ≥4-D nests (N-D grid construction),
    negative coefficients (mirrored-origin windows), repeated levels and
    constant dims (in-kernel index gather).

Everything here is pure data — importing it never touches torch.
"""
from __future__ import annotations

from dataclasses import dataclass

# --- machine-readable codes (stable API for tests / the harness) -----------
#
# Still-active fallback codes: plans carrying one of these stay on XLA.
R_LHS_FORM = "lhs-form"
R_ZERO_COEF = "zero-coefficient"
R_FRACTIONAL_OFFSET = "fractional-offset"
R_MIXED_STRIDE = "mixed-stride"
R_INCONSISTENT_LAYOUT = "inconsistent-layout"
R_STRIDED_AUX = "strided-aux"
R_SCALAR_AUX = "scalar-aux"
R_NO_BASE_ARRAY = "no-base-array"

#: Retired fallback codes: since the dimension-generic lowering engine these
#: never appear as fallback *reasons* — they appear as lowering *facts*
#: naming the mechanism that absorbs them (kept under the same names so the
#: fallback→fact promotion is visible in diffs and dashboards).
R_DEPTH = "depth"  # 1-D / ≥4-D nests → N-D grid construction
R_NEGATIVE_COEF = "negative-coefficient"  # → mirrored-origin windows
R_REPEATED_LEVEL = "repeated-level"  # → in-kernel index gather
R_CONSTANT_DIM = "constant-dim"  # → in-kernel index gather

#: The codes that can still appear in ``Capability.reasons``.
FALLBACK_CODES = (R_LHS_FORM, R_ZERO_COEF, R_FRACTIONAL_OFFSET,
                  R_MIXED_STRIDE, R_INCONSISTENT_LAYOUT, R_STRIDED_AUX,
                  R_SCALAR_AUX, R_NO_BASE_ARRAY)

#: The codes that appear only as lowering facts now.
RETIRED_CODES = (R_DEPTH, R_NEGATIVE_COEF, R_REPEATED_LEVEL, R_CONSTANT_DIM)

# Codes of the Hopper kernel alone (the reference has no counterpart): plans
# or environments carrying one of these stay on the "torch" evaluator.
#: the aux tiles overflow the card's shared memory even at a 1-point tile
R_HOPPER_SMEM = "hopper-smem"
#: operands that mix dtypes, or a dtype the kernel is not instantiated for
#: (it takes float16, bfloat16, float32 and float64; integers are refused)
R_HOPPER_DTYPE = "hopper-dtype"


@dataclass(frozen=True)
class FallbackReason:
    """One structural obstacle to the kernel path."""

    code: str
    detail: str

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"{self.code}: {self.detail}"


@dataclass(frozen=True)
class LoweringFact:
    """One envelope-widening mechanism a plan engages (not an obstacle).

    ``code`` reuses the retired fallback code the mechanism absorbed, so a
    dashboard diffing probe output across versions sees the same identifier
    move from the reasons column to the facts column."""

    code: str
    detail: str

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"{self.code}: {self.detail}"


class LoweringError(ValueError):
    """Raised when the lowering engine is asked to specialize an ineligible
    plan; carries the same structured reasons the capability probe reports,
    so engine and probe can be asserted to agree."""

    def __init__(self, reasons, message: str = ""):
        self.reasons = tuple(reasons)
        super().__init__(
            message or "; ".join(str(r) for r in self.reasons)
            or "plan is outside the kernel lowering model")

    @property
    def codes(self) -> tuple:
        return tuple(r.code for r in self.reasons)
