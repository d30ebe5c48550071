"""RACE front door of the PyTorch port: detection, contraction, analysis and
execution behind one call (paper Fig. 3 workflow).  Port of
``repro/core/race.py``.

    result = race(program)                      # binary, bitwise-faithful
    result = race(program, reassociate=3)       # n-ary path (Section 7)
    out = result.run(env)                       # on cuda; device="cpu" asks
                                                # for the CPU
    outs = result.run_batch([env0, env1])       # (B, ...) per output

``reassociate`` levels follow Section 7.1 (see the reference module).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import analysis
from .backend import BACKENDS, Capability, Selection, probe_hopper, select_backend
from .codegen import build_baseline_evaluator, build_plan_evaluator
from .depgraph import Plan, finalize, materialized_elements
from .detect import PaperCost, Transformed, detect_binary
from .ir import Program, fmt_expr, fmt_ref


@dataclass
class RaceResult:
    program: Program
    plan: Plan
    transformed: Transformed
    options: dict

    # --- analysis ----------------------------------------------------------
    def profit(self):
        return analysis.profit(self.plan)

    def op_table(self, base: bool = False):
        return analysis.op_table(self.program, None if base else self.plan)

    def reduced_ops(self) -> float:
        return analysis.reduced_ops_fraction(self.program, self.plan)

    def n_aux(self) -> int:
        """Auxiliary arrays *found* (paper Table 1 'AA Num'); contraction may
        inline some of them away (see n_aux_materialized)."""
        return len(self.transformed.aux)

    def n_aux_materialized(self) -> int:
        return len(self.plan.aux_order)

    def rounds(self) -> int:
        return self.plan.rounds

    def materialized_elements(self, contracted: bool = True) -> int:
        return materialized_elements(self.plan, contracted)

    # --- execution ---------------------------------------------------------
    def evaluator(self):
        return build_plan_evaluator(self.plan)

    def baseline_evaluator(self):
        return build_baseline_evaluator(self.program)

    def capability(self) -> Capability:
        """The Hopper kernel's verdict on this plan (no dtypes given)."""
        return probe_hopper(self.plan)

    def select_backend(self, backend: Optional[str] = None) -> Selection:
        """Resolve a backend request (default: the one given to ``race``)."""
        return select_backend(self.plan, backend or self.options["backend"])

    def run(self, env: dict, backend: Optional[str] = None, *, device=None,
            block_rows: int = 0, block_cols: int = 0, block_inner: int = 0):
        """Execute the plan; returns ``{output name: tensor over the
        statement ranges}`` (the interior convention) on ``device``.

        ``device=None`` means ``cuda``, and raises when no GPU is present;
        pass ``device="cpu"`` to run on the CPU, where the ``"hopper"``
        backend runs the kernel's tile emulator.  ``env`` may hold numpy
        arrays, scalars or tensors; they are moved to the device.
        ``block_*`` override the kernel's tile chooser (0 = choose)."""
        from .executor import compile_plan, env_to_torch, resolve_device

        env = env_to_torch(env, resolve_device(device))
        ex = compile_plan(self.plan, env, backend or self.options["backend"],
                          block_rows=block_rows, block_cols=block_cols,
                          block_inner=block_inner)
        return ex(env)

    def run_batch(self, envs, backend: Optional[str] = None, *, device=None,
                  block_rows: int = 0, block_cols: int = 0,
                  block_inner: int = 0):
        """Batched execution: ``envs`` is a sequence of same-signature envs
        or a stacked dict whose every entry carries a leading batch axis
        (scalars as ``(B,)``).  Returns ``{output name: (B, ...) tensor}``
        with ``out[name][b] == run(envs[b])[name]``, on ``device`` as
        :meth:`run` (``None``: cuda, raising without a GPU).  ``run`` and
        ``run_batch`` share one executor: it is keyed on the per-example
        signature.  On ``"hopper"`` the batch is one kernel launch, the
        examples on the grid's second axis."""
        from .executor import (compile_plan, resolve_device, stack_envs,
                               stacked_signature)

        dev = resolve_device(device)
        stacked = stack_envs(envs, dev)
        ex = compile_plan(self.plan, stacked_signature(stacked),
                          backend or self.options["backend"], device=dev,
                          block_rows=block_rows, block_cols=block_cols,
                          block_inner=block_inner)
        return ex.run_batch(stacked)

    # --- pretty ------------------------------------------------------------
    def to_source(self) -> str:
        vn = {l.level: l.var for l in self.program.loops}
        lines = []
        for circle_key, names in self.plan.circles:
            rng = dict(circle_key)
            hdr = " ".join(
                f"for {vn.get(l, f'i{l}')} in [{lo},{hi}]"
                for l, (lo, hi) in rng.items())
            lines.append(f"# circle {hdr}")
            for nm in names:
                aux = next(a for a in self.plan.aux_order if a.name == nm)
                lines.append(f"  {fmt_ref(aux.lhs(), vn)} = "
                             f"{fmt_expr(self.plan.aux_exprs[nm], vn)}")
        hdr = " ".join(f"for {l.var} in [{l.lo},{l.hi}]"
                       for l in self.program.loops)
        lines.append(f"# main {hdr}")
        for st in self.plan.body:
            lines.append(f"  {fmt_ref(st.lhs, vn)} = {fmt_expr(st.rhs, vn)}")
        return "\n".join(lines)


def race(
    program: Program,
    reassociate: int = 0,
    esr: bool = False,
    contraction: bool = True,
    cost_model: Optional[object] = None,
    rewrite_sub: bool = True,
    rewrite_div: bool = False,
    max_rounds: int = 64,
    mis_exact_limit: int = 40,
    backend: Optional[str] = None,
) -> RaceResult:
    """Run RACE on a program.

    ``backend`` records the request :meth:`RaceResult.run` honors:
    ``"torch"`` (whole-array evaluator), ``"hopper"`` (the CUDA stencil
    kernel; raises ``BackendUnavailable`` when the plan is ineligible) or
    ``"auto"`` (the kernel when the probe passes, the evaluator otherwise,
    with the reasons in the Selection).  ``None`` resolves to
    ``$RACE_BACKEND`` or ``"auto"``."""
    if backend is None:
        from .executor import default_backend

        backend = default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if reassociate:
        from .nary import detect_nary

        transformed = detect_nary(
            program,
            level=reassociate,
            cost_model=cost_model or PaperCost(),
            rewrite_sub=rewrite_sub,
            rewrite_div=rewrite_div,
            max_rounds=max_rounds,
            restrict_innermost=esr,
            mis_exact_limit=mis_exact_limit,
        )
    else:
        transformed = detect_binary(
            program,
            cost_model=cost_model or PaperCost(),
            max_rounds=max_rounds,
            restrict_innermost=esr,
        )
    plan = finalize(transformed, contraction=contraction)
    return RaceResult(program, plan, transformed, dict(
        reassociate=reassociate, esr=esr, contraction=contraction,
        backend=backend, rewrite_div=rewrite_div))
