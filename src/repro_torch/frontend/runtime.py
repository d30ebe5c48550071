"""Own copy of ``repro/frontend/runtime.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_frontend.py`` holds the
two against drift.

The ``@race_kernel`` decorator: capture + optimize + execute.

Wraps a plain-Python loop nest so it runs through the whole RACE pipeline
(capture -> detection -> contraction -> the torch evaluator or the Hopper
kernel)::

    @race_kernel(reassociate=3)
    def blur(u, out):
        n, m = u.shape
        for i in range(1, n - 1):
            for j in range(1, m - 1):
                out[i, j] = (u[i - 1, j] + u[i + 1, j]) / 2.0

    out = blur.run({"u": u, "out": out})          # on cuda, backend auto
    out = blur.run(env, device="cpu")             # on the CPU
    res = blur.trace({"u": (64, 64), "out": (64, 64)})  # RaceResult

Programs and :class:`~repro_torch.core.race.RaceResult` objects are cached
per (shapes, consts, options) signature, so repeated ``run`` calls with
same-shaped inputs pay capture + detection once.  Execution itself flows
through the plan-keyed compiled-executor cache
(:mod:`repro_torch.core.executor`), so repeated ``run``/``run_batch`` calls
also pay the specialization (and, on the card, the kernel's build)
exactly once per signature.

``device`` is ``RaceResult.run``'s: ``None`` means ``cuda`` (raising when
no card is present), ``"cpu"`` asks for the CPU.  Shapes are read off each
value's ``.shape``, so a tensor on the card is never copied to the host to
learn its shape.

``race_kernel(tune=True)`` additionally routes the strategy / backend /
block-config choice through the persistent autotuner
(:mod:`repro_torch.tuning`): the first ``run`` per input signature measures
the candidate space on the run's device — or answers from the on-disk store
when this machine tuned the kernel before — and every later call executes
the recorded winner.  Pass a dict to forward options, e.g.
``race_kernel(tune=dict(levels=(0, 3)))``.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Mapping, Optional

import numpy as np

from .capture import capture
from .diagnostics import CaptureError  # noqa: F401 - re-export convenience


def _shape(v) -> tuple:
    """A value's shape, read off its ``.shape`` where it has one (a tensor
    on the card is never copied to the host to learn it)."""
    shp = getattr(v, "shape", None)
    return tuple(shp) if shp is not None else np.shape(v)


def _freeze(mapping: Optional[Mapping]) -> tuple:
    def fz(v):
        if isinstance(v, (tuple, list)):
            return tuple(fz(x) for x in v)
        if isinstance(v, dict):  # e.g. tune=dict(levels=(0, 3))
            return tuple(sorted((k, fz(x)) for k, x in v.items()))
        return v

    return tuple(sorted((k, fz(v)) for k, v in (mapping or {}).items()))


class RaceKernel:
    """A captured-on-demand RACE kernel around a plain Python function."""

    def __init__(self, fn: Callable, **race_opts):
        self.fn = fn
        self.race_opts = race_opts
        functools.update_wrapper(self, fn)
        self._programs: dict = {}
        self._results: dict = {}
        self.last_capture_seconds: Optional[float] = None

    @property
    def params(self) -> tuple:
        code = self.fn.__code__
        return code.co_varnames[:code.co_argcount + code.co_kwonlyargcount]

    # -- capture ------------------------------------------------------------

    def capture(self, shapes: Mapping[str, tuple],
                consts: Optional[Mapping] = None):
        """Capture (cached) the function as a Program for these shapes."""
        key = (_freeze(shapes), _freeze(consts))
        if key not in self._programs:
            t0 = time.perf_counter()
            self._programs[key] = capture(self.fn, shapes, consts)
            self.last_capture_seconds = time.perf_counter() - t0
        return self._programs[key]

    def trace(self, shapes: Mapping[str, tuple],
              consts: Optional[Mapping] = None, **overrides):
        """Run RACE (cached) on the captured program; returns a RaceResult."""
        from ..core.race import race

        opts = {**self.race_opts, **overrides}
        key = (_freeze(shapes), _freeze(consts), _freeze(opts))
        if key not in self._results:
            self._results[key] = race(self.capture(shapes, consts), **opts)
        return self._results[key]

    # -- execution ----------------------------------------------------------

    def _shapes_from_env(self, env: Mapping,
                         consts: Optional[Mapping] = None,
                         batched: bool = False) -> dict:
        skip = set(consts or ())  # const-bound params need no env entry
        missing = [p for p in self.params if p not in env and p not in skip]
        if missing:
            raise ValueError(
                f"{self.fn.__name__} needs inputs for parameters {missing}; "
                f"got {sorted(env)}")
        return {p: _shape(env[p])[1:] if batched else _shape(env[p])
                for p in self.params if p not in skip}

    def run(self, env: Mapping, backend: Optional[str] = None,
            consts: Optional[Mapping] = None, *, device=None,
            **run_kw) -> dict:
        """Capture for ``env``'s shapes and execute on the backend layer,
        on ``device`` (``None``: cuda).

        ``env`` maps parameter names to arrays/scalars/tensors (extra entries
        are ignored); *every* function parameter must be present — including
        output arrays (pass them zero-filled, like the plain function would
        receive them), since their shapes participate in capture.  Returns
        the interior-convention output dict of :meth:`RaceResult.run`.
        """
        res = self.trace(self._shapes_from_env(env, consts), consts)
        return res.run(dict(env), backend=backend, device=device, **run_kw)

    __call__ = run

    def run_batch(self, envs, backend: Optional[str] = None,
                  consts: Optional[Mapping] = None, *, device=None,
                  **run_kw) -> dict:
        """Batched serving: capture once, run one executor over a stack of
        same-signature environments (see
        :meth:`repro_torch.core.race.RaceResult.run_batch`: on ``"hopper"``
        one kernel launch).  ``envs`` is a sequence of env mappings, or an
        already-stacked env dict whose every entry carries a leading batch
        axis; returns ``{output: (B, ...) tensor}`` on ``device``."""
        if isinstance(envs, Mapping):
            res = self.trace(
                self._shapes_from_env(envs, consts, batched=True), consts)
            return res.run_batch(dict(envs), backend=backend, device=device,
                                 **run_kw)
        envs = list(envs)
        if not envs:
            raise ValueError("run_batch needs at least one env")
        res = self.trace(self._shapes_from_env(envs[0], consts), consts)
        return res.run_batch([dict(e) for e in envs], backend=backend,
                             device=device, **run_kw)

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"<race_kernel {self.fn.__name__} "
                f"opts={self.race_opts or '{}'} "
                f"traced={len(self._results)}>")


def race_kernel(fn: Optional[Callable] = None, **race_opts):
    """Decorator form of the frontend; bare or parametrized.

    ``@race_kernel`` / ``@race_kernel(reassociate=4, backend="hopper")`` /
    ``@race_kernel(tune=True)`` (autotuned strategy + backend + blocks).
    Keyword options forward to :func:`repro_torch.core.race.race`.
    """
    if fn is None:
        return lambda f: RaceKernel(f, **race_opts)
    return RaceKernel(fn, **race_opts)
