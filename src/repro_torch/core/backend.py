"""Execution-backend selection for RACE plans on the PyTorch port.

Two realizations exist for an executable :class:`~.depgraph.Plan`:

  * ``"torch"``  — the whole-array evaluator (:mod:`.codegen`); handles every
                   program in the paper's scope, on any device;
  * ``"hopper"`` — the hand-written CUDA stencil kernel generated per plan
                   (:mod:`repro_torch.lowering`).

``"auto"`` picks ``"hopper"`` when the probe passes and ``"torch"``
otherwise; the :class:`Selection` carries the structured reasons either way.

The probe starts from :func:`~repro_torch.lowering.geometry.kernel_analysis`,
the analysis the kernel is built from, and adds what the card refuses:
aux rings that overflow shared memory even at a one-point plane tile
(``hopper-smem``) and operand dtypes the kernel is not instantiated for
(``hopper-dtype``).  It drops one reference code: ``scalar-aux``, since the
kernel evaluates rank-0 aux once per thread into registers
(:func:`~repro_torch.lowering.geometry.analyze_plan` keeps reporting it as
the reference does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from ..lowering.blocks import choose_tile
from ..lowering.emit import KERNEL_DTYPES, dtype_reasons
from ..lowering.facts import FallbackReason, LoweringError, LoweringFact
from ..lowering.geometry import kernel_analysis
from .depgraph import Plan

BACKENDS = ("torch", "hopper", "auto")

__all__ = ["BACKENDS", "KERNEL_DTYPES", "BackendUnavailable", "Capability",
           "FallbackReason", "LoweringFact", "Selection", "probe_hopper",
           "select_backend"]


@dataclass(frozen=True)
class Capability:
    """Result of probing a plan for the Hopper kernel.

    ``reasons`` are the structural obstacles (empty when eligible);
    ``facts`` are the mechanisms the lowering engages (informational)."""

    eligible: bool
    reasons: tuple = ()
    facts: tuple = ()

    def explain(self) -> str:
        if self.eligible:
            if self.facts:
                return "hopper-eligible (" + "; ".join(
                    str(f) for f in self.facts) + ")"
            return "hopper-eligible"
        return "; ".join(str(r) for r in self.reasons)


@dataclass(frozen=True)
class Selection:
    """A resolved backend choice plus the probe that justified it."""

    backend: str  # "torch" | "hopper"
    requested: str
    capability: Capability

    @property
    def fell_back(self) -> bool:
        return self.requested in ("hopper", "auto") and self.backend == "torch"


class BackendUnavailable(RuntimeError):
    """Raised when ``backend="hopper"`` is demanded for an ineligible plan."""

    def __init__(self, capability: Capability):
        self.capability = capability
        super().__init__(
            f"plan cannot take the Hopper kernel: {capability.explain()}")


def probe_hopper(plan: Plan, dtypes: Optional[Iterable[str]] = None
                 ) -> Capability:
    """Probe a plan (and, when given, its operand dtype names) for the kernel.

    Without ``dtypes`` the shared-memory check assumes 8-byte operands, the
    widest the kernel takes."""
    a = kernel_analysis(plan)
    reasons = list(a.reasons)
    if a.eligible:
        dtypes = tuple(dtypes or ())
        reasons += dtype_reasons(dtypes)
        if not reasons:
            itemsize = max((KERNEL_DTYPES[d] for d in dtypes), default=8)
            try:  # the tile chooser owns the shared-memory refusal
                choose_tile(plan, itemsize)
            except LoweringError as e:
                reasons += e.reasons
    return Capability(eligible=not reasons, reasons=tuple(reasons),
                      facts=a.facts)


def select_backend(plan: Plan, requested: str = "auto",
                   dtypes: Optional[Iterable[str]] = None) -> Selection:
    """Resolve ``requested`` against the plan's capability.

    ``"auto"`` prefers the kernel when eligible, else the torch evaluator (the
    reasons travel in the returned Selection).  ``"hopper"`` raises
    :class:`BackendUnavailable` on an ineligible plan."""
    if requested not in BACKENDS:
        raise ValueError(
            f"unknown backend {requested!r}; choose from {BACKENDS}")
    cap = probe_hopper(plan, dtypes)
    if requested == "torch":
        return Selection("torch", requested, cap)
    if requested == "hopper" and not cap.eligible:
        raise BackendUnavailable(cap)
    return Selection("hopper" if cap.eligible else "torch", requested, cap)
