"""Plan-keyed compiled executor cache for the PyTorch port.

Port of ``repro/core/executor.py``.  A canonical structural hash over the
executable :class:`~.depgraph.Plan` keys a process-wide executor cache, so
the same stencil run again and again on same-shaped data pays the
specialization (and, on the card, the kernel build) once.

  * :func:`plan_fingerprint` / :func:`plan_hash` / :func:`program_hash` —
    the reference's canonical serializations, byte for byte, so both packages
    give equal hashes for equal plans;
  * :func:`env_signature` — ``(name, shape, dtype)`` per entry.  The
    reference adds jax's weak-type flag; torch has no weak types, so the port
    drops it;
  * :class:`CompiledRace` — one specialization per ``(plan hash, env
    signature, backend, block config, device)``: the torch evaluator, or the
    Hopper kernel's wrapper (:class:`~repro_torch.lowering.emit.
    LoweredStencil`).  Torch runs eagerly, so there is no jit to reuse and no
    ``donate_argnums``: outputs are fresh tensors on every call;
  * :class:`ExecutorCache` — thread-safe LRU with hit/miss/eviction stats;
    :func:`compile_plan` is the front door.
"""
from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..lowering.geometry import analyze_plan
from .backend import BACKENDS, Selection, select_backend
from .depgraph import Plan
from .ir import Const, Expr, FuncName, Node, Program, Ref

#: env knobs: RACE_EXECUTOR_CACHE_SIZE — LRU capacity of the process-wide
#: cache; RACE_BACKEND — backend when a caller doesn't pick one
ENV_CACHE_SIZE = "RACE_EXECUTOR_CACHE_SIZE"
ENV_BACKEND = "RACE_BACKEND"


def _env_cache_size(default: int = 128) -> int:
    raw = os.environ.get(ENV_CACHE_SIZE, "").strip()
    if not raw:
        return default
    try:
        size = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_CACHE_SIZE}={raw!r} is not an integer") from None
    if size < 1:
        raise ValueError(f"{ENV_CACHE_SIZE} must be >= 1, got {size}")
    return size


def default_backend() -> str:
    """``$RACE_BACKEND`` or ``"auto"``; an unknown value raises."""
    b = os.environ.get(ENV_BACKEND, "").strip() or "auto"
    if b not in BACKENDS:
        raise ValueError(f"{ENV_BACKEND}={b!r} is not one of {BACKENDS}")
    return b


# ---------------------------------------------------------------------------
# canonical structural hash over plans (identical to the reference's)
# ---------------------------------------------------------------------------


def _tok(e: Expr) -> tuple:
    """Canonical token tree of an expression (hash-stable across processes)."""
    if isinstance(e, Ref):
        return ("ref", e.name, tuple(
            (s.a, s.s, Fraction(s.b).numerator, Fraction(s.b).denominator)
            for s in e.subs))
    if isinstance(e, Const):
        return ("const", repr(float(e.val)))
    if isinstance(e, FuncName):
        return ("func", e.name)
    if isinstance(e, Node):
        return ("node", e.op) + tuple(_tok(k) for k in e.kids)
    raise TypeError(f"unknown expression node {e!r}")


def plan_fingerprint(plan: Plan) -> tuple:
    """Canonical nested-tuple serialization of a plan's executable structure
    (loop variable names excluded)."""
    prog = plan.program
    return (
        "race-plan-v1",
        tuple((l.level, l.lo, l.hi) for l in prog.loops),
        tuple((_tok(st.lhs), _tok(st.rhs)) for st in plan.body),
        tuple((a.name, tuple(a.levels), _tok(plan.aux_exprs[a.name]),
               tuple(sorted(plan.ranges[a.name].items())))
              for a in plan.aux_order),
        tuple(sorted(plan.local)),
    )


def plan_hash(plan: Plan) -> str:
    """16-hex-digit structural hash of a plan, memoized on the instance."""
    h = getattr(plan, "_structural_hash", None)
    if h is None:
        h = hashlib.sha256(
            repr(plan_fingerprint(plan)).encode()).hexdigest()[:16]
        plan._structural_hash = h
    return h


def program_fingerprint(prog: Program) -> tuple:
    """Canonical serialization of an untransformed program."""
    return (
        "race-program-v1",
        tuple((l.level, l.lo, l.hi) for l in prog.loops),
        tuple((_tok(st.lhs), _tok(st.rhs)) for st in prog.body),
    )


def program_hash(prog: Program) -> str:
    """16-hex-digit structural hash of a program, memoized on the instance."""
    h = getattr(prog, "_structural_hash", None)
    if h is None:
        h = hashlib.sha256(
            repr(program_fingerprint(prog)).encode()).hexdigest()[:16]
        object.__setattr__(prog, "_structural_hash", h)
    return h


# ---------------------------------------------------------------------------
# devices and environments
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``cuda`` unless the caller names another.

    Raises when CUDA is asked for (or defaulted to) and no GPU is present:
    nothing quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def env_to_torch(env: Mapping, device) -> dict:
    """Contiguous tensors on ``device`` for every entry of ``env``.

    numpy arrays and scalars keep their dtype; python floats become float64
    and python ints int64 0-d tensors.  Tensors already on the device are
    kept as they are when contiguous."""
    dev = torch.device(device)
    out = {}
    for nm, v in env.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v, device=dev)
        out[nm] = t.contiguous()
    return out


def _dt_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def env_signature(env: Mapping) -> tuple:
    """``((name, shape, dtype), ...)`` sorted by name, for a tensor env.

    Unlike the reference there is no weak-type flag: torch has no weak
    types."""
    return tuple((nm, tuple(env[nm].shape), _dt_name(env[nm].dtype))
                 for nm in sorted(env))


@dataclass(frozen=True)
class ExecutorKey:
    """Full identity of one compiled specialization."""

    plan: str  # structural plan hash
    env: tuple  # env_signature
    backend: str  # resolved: "torch" | "hopper"
    blocks: Optional[tuple]  # (block_rows, block_cols, block_inner) | None
    device: str  # torch device the executor runs on


# ---------------------------------------------------------------------------
# compiled executor
# ---------------------------------------------------------------------------


class CompiledRace:
    """One specialization of a plan: the torch evaluator or the kernel's
    wrapper, built once per :class:`ExecutorKey`.  ``calls`` counts runs and
    ``kernel_launches`` the Hopper kernel launches among them."""

    def __init__(self, plan: Plan, env_sig: tuple, selection: Selection, *,
                 device: torch.device, block_rows: int = 0,
                 block_cols: int = 0, block_inner: int = 0):
        self.plan = plan
        self.env_sig = env_sig
        self.selection = selection
        self.backend = selection.backend
        self.device = device
        self.calls = 0
        if self.backend == "hopper":
            from ..lowering.emit import specialize_stencil

            self.spec = specialize_stencil(
                plan, {nm: shp for nm, shp, _ in env_sig},
                {nm: dt for nm, _, dt in env_sig}, block_rows=block_rows,
                block_cols=block_cols, block_inner=block_inner)
            self._core = self.spec.apply
        else:
            from .codegen import build_plan_evaluator, interior

            self.spec = None
            plan_run = build_plan_evaluator(plan)
            self._core = lambda env: interior(plan, plan_run(env))

    @property
    def kernel_launches(self) -> int:
        return self.spec.launches if self.spec is not None else 0

    def run(self, env: Mapping) -> dict:
        """Execute; returns interior-convention outputs."""
        self.calls += 1
        return self._core(env)

    __call__ = run

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"<CompiledRace {self.backend} plan={plan_hash(self.plan)} "
                f"device={self.device} calls={self.calls}>")


# ---------------------------------------------------------------------------
# process-wide LRU cache
# ---------------------------------------------------------------------------


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions, hit_rate=self.hit_rate)


class ExecutorCache:
    """Thread-safe LRU of :class:`CompiledRace` executors.  The build happens
    under the lock, so concurrent first calls make exactly one executor."""

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = _env_cache_size() if maxsize is None else maxsize
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def get_or_build(self, key: ExecutorKey,
                     builder: Callable[[], CompiledRace]) -> CompiledRace:
        with self._lock:
            ex = self._entries.get(key)
            if ex is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return ex
            self.stats.misses += 1
            ex = self._entries[key] = builder()
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            return ex

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats = CacheStats()

    def stats_snapshot(self) -> dict:
        """Hit/miss/eviction counts read together under the lock."""
        with self._lock:
            return self.stats.snapshot()

    def __len__(self) -> int:
        return len(self._entries)


_CACHE = ExecutorCache()


def executor_cache() -> ExecutorCache:
    """The process-wide cache (shared by every ``RaceResult.run``)."""
    return _CACHE


def compile_plan(plan: Plan, env: Mapping, backend: Optional[str] = None, *,
                 block_rows: int = 0, block_cols: int = 0,
                 block_inner: int = 0,
                 cache: Optional[ExecutorCache] = None) -> CompiledRace:
    """Fetch (or build) the executor for this (plan, tensor env) pairing.

    The env's tensors fix the device.  ``backend=None`` resolves to
    ``$RACE_BACKEND`` (default ``"auto"``); ``"auto"`` takes the kernel when
    the probe passes for the plan and the env's dtypes."""
    sig = env_signature(env)
    devices = {v.device for v in env.values()}
    if len(devices) != 1:
        raise ValueError(f"env tensors lie on several devices: {devices}")
    (device,) = devices
    arrays = analyze_plan(plan).arrays
    base = [dt for nm, _, dt in sig if nm in arrays]
    sel = select_backend(plan, backend or default_backend(), base)
    blocks = ((block_rows, block_cols, block_inner)
              if sel.backend == "hopper" else None)
    key = ExecutorKey(plan_hash(plan), sig, sel.backend, blocks, str(device))
    c = cache if cache is not None else _CACHE
    return c.get_or_build(key, lambda: CompiledRace(
        plan, sig, sel, device=device, block_rows=block_rows,
        block_cols=block_cols, block_inner=block_inner))
