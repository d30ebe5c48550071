"""Oracles for the RACE stencil kernel: the whole-array ``"torch"``
evaluator restricted to the statement interior the kernel produces.  Port
of ``repro/kernels/ref.py``: :func:`reference` evaluates the untransformed
program (ground truth), :func:`reference_plan` the RACE plan (the same
realization the ``"torch"`` backend runs).  Both move ``env`` to ``device``
first (``None``: cuda, as every entry point of the port)."""
from __future__ import annotations

from ..core.codegen import (build_baseline_evaluator, build_plan_evaluator,
                            interior)
from ..core.depgraph import Plan
from ..core.executor import env_to_torch, resolve_device

__all__ = ["interior", "reference", "reference_plan"]


def reference(plan: Plan, env: dict, *, device=None) -> dict:
    """Oracle: evaluate the *baseline* program (ground truth semantics)."""
    env = env_to_torch(env, resolve_device(device))
    return interior(plan, build_baseline_evaluator(plan.program)(env))


def reference_plan(plan: Plan, env: dict, *, device=None) -> dict:
    """Secondary oracle: the transformed-program evaluator (checks that the
    kernel agrees with the ``"torch"`` realization of the same plan)."""
    env = env_to_torch(env, resolve_device(device))
    return interior(plan, build_plan_evaluator(plan)(env))
