"""Fault-tolerant training driver of the port (``repro/runtime/trainer.py``).

Responsibilities (DESIGN.md section 6 — design point is 1000+ nodes, the
mechanisms all run at any scale):
  * run the train step over the deterministic sharded data pipeline;
  * periodic async checkpointing; on ANY failure (NaN loss, device error,
    preemption signal) the driver restores the latest valid checkpoint and
    replays from there — the data pipeline is step-addressed so replay is
    exact (tested: kill -9 mid-run resumes bit-identically);
  * SIGTERM/SIGINT preemption hook: checkpoint-then-exit;
  * straggler monitor: per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are logged with the host id so an external
    scheduler can eject the host (on a single host this is observability);
  * NaN quarantine: a non-finite loss triggers restore + skip of the
    offending data window (``skip_on_nan``).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

import torch

from ..checkpoint import CheckpointManager, latest_step, restore_checkpoint
from ..core.executor import cache_stats
from ..data import ShardedTokenPipeline
from ..tree import copy_, map_leaves


@dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1
    skip_on_nan: bool = True
    max_restarts: int = 3
    log_every: int = 10
    log_fn: Callable = print


class Trainer:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over ``pipeline``'s batches.  ``params`` is a trainable LM
    (or any module with ``param_tree()``), updated in place by the step and
    by a restore; the checkpoint holds ``{"params": its param tree, "opt":
    opt_state}`` under the reference's keys.  A
    :class:`~repro_torch.models.spmd.MeshLM` (a step on a mesh) is
    checkpointed gathered, bit for bit, and restored placed back by its
    shardings (``restore_checkpoint(shardings=)``)."""

    def __init__(self, cfg: TrainerConfig, train_step, pipeline: ShardedTokenPipeline,
                 params, opt_state):
        self.cfg = cfg
        self.train_step = train_step
        self.pipe = pipeline
        self.params = params
        self.opt_state = opt_state
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                      async_save=cfg.async_save)
        self.step = 0
        self._ema = None
        self._preempted = False
        self.straggler_events: list = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _on_mesh(self) -> bool:
        return hasattr(self.params, "mesh")

    def _state(self):
        if self._on_mesh():
            from ..models.sharding import gather_tree

            return {"params": self.params.gathered(),
                    "opt": gather_tree(self.opt_state)}
        return {"params": self.params.param_tree(), "opt": self.opt_state}

    def _save(self):
        self.ckpt.save(self.step, self._state())

    def maybe_resume(self):
        last = latest_step(Path(self.cfg.ckpt_dir))
        if last is None:
            return False
        if self._on_mesh():
            state, step = self._restore_mesh()
            self.params.load_stacked(state["params"])
            self.opt_state = state["opt"]
        else:
            like = self._state()
            state, step = self.ckpt.restore_latest(like)
            copy_(like["params"], state["params"])
            self.opt_state = state["opt"]
        self.step = step
        self.cfg.log_fn(f"[trainer] resumed from step {step}")
        return True

    def _restore_mesh(self):
        """The latest checkpoint placed by the mesh model's and the
        optimizer state's shardings."""
        from ..models.sharding import Sharding

        mp = self.params
        like = {"params": mp.structure.param_tree(),
                "opt": map_leaves(lambda pl: torch.empty(
                    pl.shape, dtype=pl.dtype, device="meta"),
                    self.opt_state)}
        shard = {"params": mp.shardings(),
                 "opt": map_leaves(lambda pl: Sharding(pl.sharding.mesh,
                                                       pl.sharding.spec),
                                   self.opt_state)}
        return restore_checkpoint(self.cfg.ckpt_dir, like, shardings=shard)

    def _install_signals(self) -> dict:
        """Preemption handlers for the run; returns the handlers they
        replace (:meth:`run` puts them back, so a finished trainer is not
        kept alive, with its parameters and optimizer state, by a process
        handler that holds it)."""
        def handler(signum, frame):
            self._preempted = True

        old = {}
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                old[s] = signal.signal(s, handler)
            except ValueError:  # not main thread (tests)
                pass
        return old

    # ------------------------------------------------------------------
    def run(self) -> dict:
        old = self._install_signals()
        try:
            return self._run()
        finally:
            for s, h in old.items():
                signal.signal(s, h)

    def _run(self) -> dict:
        self.maybe_resume()
        losses = []
        while self.step < self.cfg.total_steps:
            try:
                batch = self.pipe.batch_at(self.step)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0

                # straggler watchdog
                if self._ema is None:
                    self._ema = dt
                ratio = dt / self._ema
                if ratio > self.cfg.straggler_factor and self.step > 2:
                    self.straggler_events.append(
                        {"step": self.step, "dt": dt, "ema": self._ema})
                    self.cfg.log_fn(
                        f"[trainer] STRAGGLER step {self.step}: "
                        f"{dt:.3f}s vs ema {self._ema:.3f}s")
                self._ema = (1 - self.cfg.ema_alpha) * self._ema \
                    + self.cfg.ema_alpha * dt

                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {self.step}")

                self.step += 1
                losses.append(loss)
                if self.step % self.cfg.log_every == 0:
                    self.cfg.log_fn(
                        f"[trainer] step {self.step} loss {loss:.4f} "
                        f"({dt*1000:.0f} ms)")
                if self.step % self.cfg.ckpt_every == 0:
                    self._save()
                if self._preempted:
                    self.cfg.log_fn("[trainer] preemption: checkpoint + exit")
                    self._save()
                    self.ckpt.wait()
                    break
            except (FloatingPointError,) as e:
                self.restarts += 1
                self.cfg.log_fn(f"[trainer] FAILURE: {e}; restoring")
                if self.restarts > self.cfg.max_restarts:
                    raise
                bad_step = self.step
                if not self.maybe_resume():
                    raise
                if self.cfg.skip_on_nan and self.step == bad_step:
                    self.step += 1  # quarantine the offending window
        self.ckpt.wait()
        if self.step >= self.cfg.total_steps or self._preempted:
            self._save()
            self.ckpt.wait()
        return {"losses": losses, "stragglers": self.straggler_events,
                "restarts": self.restarts, "step": self.step,
                # RACE executor-cache counters: plan reuse across steps
                "race_cache": cache_stats()}
