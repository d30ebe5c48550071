"""Differential verification of the PyTorch port over the registry.

Port of ``repro/testing/differential.py``.  The same seed gives the same
numpy arrays in both packages, so one :func:`build_env` feeds the reference
and, through :func:`env_to_torch`, the port.  :func:`run_case` holds every
plan's outputs on the ``"torch"`` and ``"hopper"`` backends against the
untransformed baseline program (and the kernel against ``"torch"`` on the
same plan); :func:`run_grad_case` holds ``torch.autograd.grad`` through
``res.run`` against autograd of the baseline.  A backend the probe refuses
is recorded as a fallback with its reasons, never silently.

Tolerances (:func:`default_tolerances`) are the reference's rows for
float64, float32 and float16.  The reference has no bfloat16 row; the port's
was measured: on the registry (19 cases x reassociate {0, default}, sweep
sizes, the float32 ``build_env`` rounded to bfloat16), the reference's
``"xla"`` lies at most 1.08e-2 from the float64 baseline (j3d27pt, level 0)
and at float16 at most 1.28e-3 (poisson, level 0): 8.4 times apart, the
ratio of the two unit roundoffs (2**-8 / 2**-11 = 8).  The bfloat16 row is
4 times the float16 row (baseline 8e-2, plan 4e-2, grad 1.6e-1): 7.4 times
above the worst measured error, within the 8 times the unit roundoffs allow.
numpy has no bfloat16, so a bfloat16 env is the float32 one rounded to
nearest even (:func:`torch_env`), as ``jnp.bfloat16`` rounds it.

    from repro_torch.testing import sweep_registry, coverage_matrix
    print(coverage_matrix(sweep_registry(device="cpu")))
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from ..apps.paper_kernels import CASES, get_case
from ..core.backend import select_backend
from ..core.codegen import interior, required_shapes
from ..core.executor import env_to_torch, resolve_device
from ..core.race import race
from ..lowering.geometry import analyze_plan

__all__ = ["SWEEP_SIZES", "CaseReport", "ComboResult", "build_env",
           "coverage_matrix", "default_tolerances", "env_to_torch",
           "grad_sweep_registry", "rel_err", "run_case", "run_grad_case",
           "sweep_registry", "torch_env"]

#: grid sizes of the registry sweeps (the reference's)
SWEEP_SIZES = {
    "calc_tpoints": 14, "hdifft_gm": 14, "ocn_export": 14, "gaussian": 18,
    "rhs_ph1": 10, "rhs_ph2": 10, "diffusion1": 10, "diffusion2": 10,
    "diffusion3": 10, "psinv": 10, "resid": 10, "rprj3": 12,
    "j3d27pt": 10, "poisson": 10, "derivative": 10,
    "smooth1d": 24, "blocked4d": 7, "mirror_deriv": 14, "diag2d": 14,
}


def dtype_name(dtype) -> str:
    """The name of a numpy or torch dtype, or of ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


def default_tolerances(dtype) -> dict:
    """Relative tolerances per dtype: ``baseline`` (a plan vs the untransformed
    program, whose association order differs), ``plan`` (two realizations
    of the same plan) and ``grad`` (gradients vs autograd of the baseline:
    one more reduction, the adjoint contraction).  The reference's numbers,
    and the port's bfloat16 row (the module docstring derives it).  ``dtype``
    is a numpy or torch dtype, or ``"bfloat16"``."""
    return {
        "float64": dict(baseline=1e-9, plan=1e-12, grad=1e-8),
        "float32": dict(baseline=1e-4, plan=1e-5, grad=2e-4),
        "float16": dict(baseline=2e-2, plan=1e-2, grad=4e-2),
        "bfloat16": dict(baseline=8e-2, plan=4e-2, grad=1.6e-1),
    }[dtype_name(dtype)]


def build_env(case, dtype=np.float32, seed: int = 0) -> dict:
    """Random numpy inputs covering every access of the case's program.
    Scalars draw from [0.25, 1], arrays from [-1, 1]; same draws, in the same
    order, as the reference's ``build_env``."""
    rng = np.random.default_rng(seed)
    env = {}
    for nm, shp in required_shapes(case.program).items():
        if nm in case.scalars or shp == ():
            env[nm] = dtype(rng.uniform(0.25, 1.0))
        else:
            env[nm] = rng.uniform(-1, 1, shp).astype(dtype)
    return env


def torch_env(case, dtype=np.float32, seed: int = 0, device=None) -> dict:
    """:func:`build_env` as tensors on ``device`` (``None``: cuda).  For
    bfloat16, which numpy lacks, the env is built in float32 and its
    floating entries rounded to bfloat16 (to nearest even, as
    ``jnp.bfloat16`` rounds), so both packages see the same bits."""
    dev = resolve_device(device)
    if dtype_name(dtype) != "bfloat16":
        return env_to_torch(build_env(case, np.dtype(dtype).type, seed), dev)
    env = env_to_torch(build_env(case, np.float32, seed), dev)
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in env.items()}


def rel_err(got: dict, want: dict) -> float:
    """Worst relative error across outputs: max |got - want| / max |want|,
    in float64; entries may be tensors (any device) or arrays.  A
    non-finite value on either side gives ``inf``.  Two tensors
    on one device are compared there (the same float64 arithmetic, without
    copying a full-size output to the host)."""
    worst = 0.0
    for k in want:
        g, w = got[k], want[k]
        if (isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor)
                and g.device == w.device):
            g, w = g.detach().double(), w.detach().double()
            diff, scale = float((g - w).abs().max()), float(w.abs().max())
        else:
            g = np.asarray(_host(g), np.float64)
            w = np.asarray(_host(w), np.float64)
            diff, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        if not (np.isfinite(diff) and np.isfinite(scale)):
            return float("inf")  # a NaN or inf never passes a tolerance
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def _host(v):
    if not hasattr(v, "detach"):
        return v
    t = v.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# registry sweeps
# ---------------------------------------------------------------------------


@dataclass
class ComboResult:
    """One (case, reassociate, backend) execution."""

    case: str
    reassociate: int
    backend: str  # "torch" | "hopper"
    status: str  # "ok" | "fallback" | "mismatch" | "error"
    reason: str = ""  # fallback reasons or error text
    max_rel_err: Optional[float] = None  # vs the baseline
    max_rel_err_plan: Optional[float] = None  # hopper vs same-plan torch
    n_aux: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclass
class CaseReport:
    case: str
    combos: list = field(default_factory=list)

    def failures(self) -> list:
        """Mismatches, errors, and *silent* fallbacks (no reason attached)."""
        return [c for c in self.combos
                if c.status in ("mismatch", "error")
                or (c.status == "fallback" and not c.reason)]


def _hopper_refusal(res, env) -> str:
    """The probe's reasons when ``"hopper"`` cannot take this plan and env,
    else ``""``."""
    arrays = analyze_plan(res.plan).arrays
    base = [str(v.dtype).removeprefix("torch.") for k, v in env.items()
            if k in arrays]
    sel = select_backend(res.plan, "auto", base)
    return "" if sel.backend == "hopper" else sel.capability.explain()


def run_case(case, reassociate_levels: Iterable[int] = (0, 3, 4),
             backends: Iterable[str] = ("torch", "hopper"),
             dtype=np.float32, seed: int = 0, block_rows: int = 0,
             block_cols: int = 0, block_inner: int = 0,
             tolerances: Optional[dict] = None, device=None) -> CaseReport:
    """Differential-verify one case across plans and backends, on ``device``
    (``None``: cuda).  The baseline runs in float64."""
    tol = tolerances or default_tolerances(dtype)
    dev = resolve_device(device)
    env = torch_env(case, dtype, seed, dev)
    env64 = {k: v.double() if v.is_floating_point() else v
             for k, v in env.items()}
    base_res = race(case.program)
    truth = interior(base_res.plan, base_res.baseline_evaluator()(env64))
    report = CaseReport(case.name)
    for lvl in reassociate_levels:
        res = race(case.program, reassociate=lvl,
                   rewrite_div=case.rewrite_div)
        plain = None
        for backend in backends:
            combo = ComboResult(case.name, lvl, backend, "ok",
                                n_aux=res.n_aux_materialized())
            report.combos.append(combo)
            try:
                if backend == "hopper":
                    combo.reason = _hopper_refusal(res, env)
                    if combo.reason:
                        combo.status = "fallback"
                        continue
                out = res.run(env, backend, device=dev, block_rows=block_rows,
                              block_cols=block_cols, block_inner=block_inner)
                combo.max_rel_err = rel_err(out, truth)
                if combo.max_rel_err > tol["baseline"]:
                    combo.status = "mismatch"
                    combo.reason = (f"vs baseline: {combo.max_rel_err:.2e} > "
                                    f"{tol['baseline']:.0e}")
                if backend == "torch":
                    plain = out
                elif plain is not None:
                    combo.max_rel_err_plan = rel_err(out, plain)
                    if combo.max_rel_err_plan > tol["plan"]:
                        combo.status = "mismatch"
                        combo.reason += (
                            f" vs torch plan: {combo.max_rel_err_plan:.2e} "
                            f"> {tol['plan']:.0e}")
            except Exception as e:  # noqa: BLE001 - reported, not swallowed
                combo.status = "error"
                combo.reason = f"{type(e).__name__}: {e}"
    return report


def run_grad_case(case, reassociate_levels: Iterable[int] = (0, 3, 4),
                  backends: Iterable[str] = ("torch", "hopper"),
                  dtype=np.float32, seed: int = 0,
                  tolerances: Optional[dict] = None,
                  device=None) -> CaseReport:
    """Differential-verify ``torch.autograd.grad`` through ``res.run``.

    For each (reassociate level, forward backend), the gradient of a fixed
    cosine-projection loss over the interior outputs, taken through
    ``res.run`` (whose backward runs the adjoint-stencil plans), is held
    against autograd of the untransformed baseline evaluator in float64, at
    the ``grad`` tolerance, for every floating input.  ``"hopper"`` combos
    the probe refuses are recorded as fallbacks; cases whose adjoint cannot
    be built still run (the backward falls back to autograd) and carry the
    refusal on the combo."""
    from ..core.adjoint import adjoint_build

    tol = tolerances or default_tolerances(dtype)
    dev = resolve_device(device)
    env = torch_env(case, dtype, seed, dev)
    keys = sorted(k for k, v in env.items() if v.is_floating_point())
    base_res = race(case.program)
    base_eval = base_res.baseline_evaluator()
    with torch.no_grad():
        shapes = interior(base_res.plan, base_eval(env))
    # fixed projection: every output element contributes with a distinct
    # weight, so a gradient error anywhere shows in the loss
    weights = {k: torch.as_tensor(np.cos(np.arange(v.numel())).reshape(
        tuple(v.shape)), device=dev) for k, v in shapes.items()}

    def loss_of(outs):
        return sum((outs[k].double() * w).sum() for k, w in weights.items())

    def grads_of(fn, base: dict) -> dict:
        p = {k: base[k].detach().clone().requires_grad_() for k in keys}
        gs = torch.autograd.grad(loss_of(fn({**base, **p})),
                                 [p[k] for k in keys], allow_unused=True)
        return {k: torch.zeros_like(p[k]) if gv is None else gv
                for k, gv in zip(keys, gs)}

    env64 = {k: v.double() if v.is_floating_point() else v
             for k, v in env.items()}
    truth = grads_of(lambda e: interior(base_res.plan, base_eval(e)), env64)
    build = adjoint_build(case.program)
    note = "" if build.ok else f"adjoint-autodiff: {build.reason}"
    report = CaseReport(case.name)
    for lvl in reassociate_levels:
        res = race(case.program, reassociate=lvl,
                   rewrite_div=case.rewrite_div)
        for backend in backends:
            combo = ComboResult(case.name, lvl, backend, "ok", reason=note,
                                n_aux=res.n_aux_materialized())
            report.combos.append(combo)
            try:
                if backend == "hopper":
                    refusal = _hopper_refusal(res, env)
                    if refusal:
                        combo.status, combo.reason = "fallback", refusal
                        continue
                grads = grads_of(lambda e: res.run(e, backend, device=dev),
                                 env)
                combo.max_rel_err = rel_err(grads, truth)
                if combo.max_rel_err > tol["grad"]:
                    combo.status = "mismatch"
                    combo.reason = (f"grads vs baseline: "
                                    f"{combo.max_rel_err:.2e} > "
                                    f"{tol['grad']:.0e}")
            except Exception as e:  # noqa: BLE001 - reported, not swallowed
                combo.status = "error"
                combo.reason = f"{type(e).__name__}: {e}"
    return report


def sweep_registry(names: Optional[Iterable[str]] = None,
                   sizes: Optional[dict] = None, via: str = "dsl",
                   **kw) -> list:
    """Run :func:`run_case` over (a subset of) the registry at
    :data:`SWEEP_SIZES`.

    ``via="frontend"`` swaps every case's program for the one captured from
    its plain-Python twin (``repro_torch.apps.frontend_kernels``; capture
    equality is checked en route), so the sweep verifies the frontend entry
    path end to end.  With ``names=None`` the frontend sweep covers the
    twinned cases."""
    sizes = {**SWEEP_SIZES, **(sizes or {})}
    if names is None:
        names = list(CASES)
        if via == "frontend":
            from ..apps.frontend_kernels import TWINS

            names = [n for n in names if n in TWINS]
    return [run_case(get_case(n, sizes.get(n), via=via), **kw)
            for n in names]


def grad_sweep_registry(names: Optional[Iterable[str]] = None,
                        sizes: Optional[dict] = None, **kw) -> list:
    """Run :func:`run_grad_case` over (a subset of) the registry."""
    sizes = {**SWEEP_SIZES, **(sizes or {})}
    return [run_grad_case(get_case(n, sizes.get(n)), **kw)
            for n in (CASES if names is None else names)]


def coverage_matrix(reports: Iterable[CaseReport]) -> str:
    """Human-readable case x (reassociate, backend) status matrix, with the
    fallback and mismatch reasons listed below the table."""
    reports = list(reports)
    combos = sorted({(c.reassociate, c.backend)
                     for r in reports for c in r.combos})
    lines = ["  ".join(["case".ljust(14)] + [f"r{l}/{b}".ljust(12)
                                               for l, b in combos])]
    notes = []
    for r in reports:
        by_key = {(c.reassociate, c.backend): c for c in r.combos}
        row = [r.case.ljust(14)]
        for key in combos:
            c = by_key.get(key)
            if c is None:
                cell = "-"
            elif c.ok:
                cell = f"ok {c.max_rel_err:.0e}"
            elif c.status == "fallback":
                code = c.reason.split(":", 1)[0] if c.reason else "SILENT"
                cell = f"torch[{code}]"
                notes.append(f"{r.case} r{key[0]}: fallback — {c.reason}")
            else:
                cell = c.status.upper()
                notes.append(f"{r.case} r{key[0]}/{key[1]}: {c.status} — "
                             f"{c.reason}")
            row.append(cell.ljust(12))
        lines.append("  ".join(row))
    if notes:
        lines += [""] + notes
    return "\n".join(lines)
