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

from .. import obs as _obs
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

    The shared-memory check reckons each shared element at its dtype's
    compute width (4 bytes for float16 and bfloat16, which shared memory
    holds as float); without ``dtypes`` it assumes 8, the widest."""
    a = kernel_analysis(plan)
    reasons = list(a.reasons)
    if a.eligible:
        dtypes = tuple(dtypes or ())
        reasons += dtype_reasons(dtypes)
        if not reasons:
            itemsize = max((KERNEL_DTYPES[d].shared for d in dtypes),
                           default=8)
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
    if requested == "hopper":
        if not cap.eligible:
            _emit_selection(plan, requested, "unavailable", cap)
            raise BackendUnavailable(cap)
        return _emit_selection(plan, requested, "hopper", cap)
    return _emit_selection(
        plan, requested, "hopper" if cap.eligible else "torch", cap)


def _emit_selection(plan: Plan, requested: str, backend: str,
                    cap: Capability):
    """Record the probe's verdict (the reference's telemetry): a counter
    per (requested, resolved) pair, a ``backend_fallback`` event with the
    structured reasons whenever a kernel-wanting request lands on
    ``"torch"`` (or is refused outright), and a ``lowering_facts`` event
    when an eligible plan engages envelope-widening mechanisms."""
    if _obs.enabled():
        from .executor import plan_hash

        ph = plan_hash(plan)
        _obs.counter("race_backend_selections_total", requested=requested,
                     backend=backend).inc()
        if backend in ("torch", "unavailable") and cap.reasons:
            _obs.event("backend_fallback", plan=ph, requested=requested,
                       backend=backend,
                       reasons=[str(r) for r in cap.reasons],
                       codes=[r.code for r in cap.reasons])
        elif cap.facts:
            _obs.event("lowering_facts", plan=ph, backend=backend,
                       facts=[str(f) for f in cap.facts],
                       codes=[f.code for f in cap.facts])
    if backend == "unavailable":
        return None
    return Selection(backend, requested, cap)
