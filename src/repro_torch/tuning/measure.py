"""Correctness-gated measurement of one tuning candidate (PyTorch port).

Port of ``repro/tuning/measure.py``.  Every candidate runs through the
*same* plan-keyed executor path that serves production traffic
(:func:`repro_torch.core.executor.compile_plan` with an explicit backend —
never ``"auto"``, which would consult the store the tuner is about to
write), on the device of the env's tensors.  A candidate must first
reproduce the ``reassociate=0`` ``"torch"`` output within the differential
harness's ``baseline`` tolerance for its dtype; only then is it timed
(warmup + repeats, median wall time of calls that end in
``torch.cuda.synchronize`` on a card: what the serving path pays).  Gated
or refused candidates are recorded with their reason, never silently
dropped.  A ``"hopper"`` candidate is an ``error`` only where the chooser
or the probe refuses it (a ``ValueError``: a tile past an extent, rings
over shared memory); nvcc refusing K1's source (``BuildError``) or K1
failing to launch ends the search, so a kernel fault can never make the
plain ``"torch"`` candidate the stored winner.  On a card, a ``"hopper"`` candidate's first
call builds its K1 library (nvcc) unless the tuner built it beforehand.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.depgraph import Plan
from ..core.executor import compile_plan
from ..kernels.build import BuildError
# the gate uses the differential harness's own error metric, not a copy
from ..testing.differential import rel_err
from .space import Config, blocks_refusal


@dataclass
class Measurement:
    """One candidate's fate: timed, correctness-gated, or errored.

    ``batch == 0`` is the per-call path; ``batch > 0`` means the candidate
    was measured on the *batched* executor (one K1 launch for the batch on
    ``"hopper"``) at that batch size, with ``us`` normalized to per-item so
    populations stay comparable.
    """

    config: Config
    status: str  # "ok" | "gated" | "error"
    us: Optional[float] = None  # median steady-state wall time, µs (per item)
    rel_err: Optional[float] = None  # vs the reassociate=0 torch baseline
    detail: str = ""
    batch: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def as_dict(self) -> dict:
        return dict(config=self.config.as_dict(), status=self.status,
                    us=self.us, rel_err=self.rel_err, detail=self.detail,
                    batch=self.batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_us(call, device: torch.device, repeats: int,
               warmup: int) -> float:
    for _ in range(max(warmup, 1)):
        call()
    _sync(device)
    ts = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        call()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def time_executor(ex, env: Mapping, repeats: int = 5,
                  warmup: int = 2) -> float:
    """Median wall time of an already-built executor on a tensor env,
    microseconds: each call ends in a device synchronize."""
    return _median_us(lambda: ex(env), ex.device, repeats, warmup)


def time_executor_batch(ex, env: Mapping, batch: int, repeats: int = 5,
                        warmup: int = 2) -> float:
    """Median *per-item* wall time of the batched executor, microseconds.

    Stacks ``env`` to batch ``batch`` once up front on its device (the
    serving runtime dispatches pre-coalesced batches, so stacking cost is
    not what this measures) and times ``run_batch`` on the stacked dict."""
    stacked = {k: torch.stack([v] * batch) for k, v in env.items()}
    return _median_us(lambda: ex.run_batch(stacked), ex.device, repeats,
                      warmup) / batch


def measure_candidate(plan: Plan, config: Config, env: Mapping,
                      truth: Mapping, tolerance: float, *,
                      repeats: int = 5, warmup: int = 2,
                      batch: int = 0) -> Measurement:
    """Gate then time one candidate; refusals become ``status="error"``.

    ``env`` is a tensor env (its device is the candidate's).  Infeasible
    configs — a block larger than its level's extent
    (:func:`~.space.blocks_refusal`), rings over a block's shared memory
    (``hopper-smem``, raised by the chooser) — are reported here as errors:
    the tuner treats them as non-candidates rather than crashing the search.

    ``batch > 0`` measures the *batched* executor instead: the env is
    replicated to that batch size, element 0 of the stacked output is gated
    against ``truth``, and ``us`` is per-item — what the serving runtime's
    coalesced dispatch actually pays.
    """
    from .. import obs

    try:
        with obs.span("measure", config=config.describe(),
                      batch=str(batch)):
            refusal = blocks_refusal(plan, config)
            if refusal:
                raise ValueError(refusal)
            ex = compile_plan(
                plan, env, config.backend, block_rows=config.block_rows,
                block_cols=config.block_cols,
                block_inner=config.block_inner)
            if batch > 0:
                out = ex.run_batch([env] * batch)
                err = rel_err({k: v[0] for k, v in out.items()}, truth)
            else:
                err = rel_err(ex(env), truth)
            if err > tolerance:
                m = Measurement(
                    config, "gated", rel_err=err, batch=batch,
                    detail=f"vs r0/torch baseline: {err:.2e} > "
                           f"{tolerance:.0e}")
            elif batch > 0:
                us = time_executor_batch(ex, env, batch, repeats=repeats,
                                         warmup=warmup)
                m = Measurement(config, "ok", us=us, rel_err=err,
                                batch=batch)
            else:
                us = time_executor(ex, env, repeats=repeats, warmup=warmup)
                m = Measurement(config, "ok", us=us, rel_err=err)
    except BuildError:
        raise  # nvcc refused K1's source: a fault, not a candidate's fate
    except Exception as e:  # noqa: BLE001 - reported, not swallowed
        if config.backend == "hopper" and not isinstance(e, ValueError):
            raise  # K1 failed to launch or run: a fault, not a refusal
        m = Measurement(config, "error", batch=batch,
                        detail=f"{type(e).__name__}: {e}")
    if obs.enabled():
        # one event per candidate verdict: gate passes are as much a
        # decision as gate failures (the tuner's audit trail)
        from ..core.executor import plan_hash

        obs.counter("race_tuning_candidates_total", status=m.status).inc()
        obs.event("tuning_gate", plan=plan_hash(plan),
                  config=config.describe(), status=m.status,
                  rel_err=m.rel_err, us=m.us, detail=m.detail,
                  batch=m.batch)
    return m
