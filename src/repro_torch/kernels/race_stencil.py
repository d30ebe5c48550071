"""Compatibility shim: the RACE stencil kernel lives in
:mod:`repro_torch.lowering.emit`.  Port of ``repro/kernels/race_stencil.py``.

Deprecated: import from ``repro_torch.lowering.emit`` instead.  The
historical names with a counterpart in the port keep working here:
``StencilSpec`` is an alias of ``LoweredStencil``, and
``specialize_stencil`` and ``LoweringError`` are the lowering's own.

Left out, with no counterpart in the port:

  * ``plan_geometry`` — the pre-engine 5-tuple of pads, halo windows and
    BlockSpecs that fed the Pallas grid.  The Hopper kernel reads every
    operand in place through affine indices and stages plane windows
    itself, so no such geometry exists (its launch geometry and schedule
    are ``lowering.blocks.build_geometry``, of another shape);
  * ``race_stencil_call`` — the functional Pallas call, specializing on
    every call under ``jax.jit``.  Its counterpart is the executor path:
    ``repro_torch.kernels.ops.race_stencil``, or ``LoweredStencil.apply``
    on a specialized wrapper.
"""
from __future__ import annotations

from ..lowering.emit import LoweredStencil, specialize_stencil
from ..lowering.facts import LoweringError

StencilSpec = LoweredStencil

__all__ = ["LoweredStencil", "LoweringError", "StencilSpec",
           "specialize_stencil"]
