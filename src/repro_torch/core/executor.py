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
    drops it.  :func:`stacked_signature` is the per-example signature of a
    batch-stacked env;
  * :class:`CompiledRace` — one specialization per ``(plan hash, env
    signature, backend, block config, device)``: the torch evaluator, or the
    Hopper kernel's wrapper (:class:`~repro_torch.lowering.emit.
    LoweredStencil`).  Torch runs eagerly, so there is no jit to reuse and no
    ``donate_argnums``: outputs are fresh tensors on every call.
    :meth:`CompiledRace.run_batch` runs a batch on the same executor (the
    key is the per-example signature): ``torch.func.vmap`` of the evaluator,
    or one kernel launch with the batch on the grid's second axis.  On both
    backends both calls differentiate, to any order: when autograd records
    and an input requires grad, the call goes through
    :class:`_RaceFunction`, whose backward runs the adjoint-stencil plans
    (:mod:`.adjoint`) through this executor layer again; otherwise it calls
    the bare core;
  * :class:`ExecutorCache` — thread-safe LRU with hit/miss/eviction stats;
    :func:`compile_plan` is the front door.  On ``"auto"`` it consults the
    persistent autotuning store (:mod:`repro_torch.tuning`) first, as the
    reference's does.

With ``RACE_OBS`` on (:mod:`repro_torch.obs`), the reference's telemetry:
a ``lower`` span around each specialization, a ``compile`` span on an
executor's first call and a ``run`` span on every later one (labelled
``batch="1"`` on the batched path), the run and cache counters, the cache
size gauge and the ``executor_build`` / ``executor_evict`` events.  A
span is the host's time: a kernel launch returns before the card finishes
it, and nothing here synchronizes.  With obs off, a call reads one flag.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .. import obs as _obs
from ..lowering.geometry import kernel_analysis, kernel_memo
from .backend import BACKENDS, Selection, select_backend
from .depgraph import Plan
from .ir import Const, Expr, FuncName, Node, Program, Ref

#: env knobs: RACE_EXECUTOR_CACHE_SIZE — LRU capacity of the process-wide
#: cache; RACE_BACKEND — backend when a caller doesn't pick one
ENV_CACHE_SIZE = "RACE_EXECUTOR_CACHE_SIZE"
ENV_BACKEND = "RACE_BACKEND"
#: seconds between two consults of the tuning store for one plan,
#: signature and device on the ``"auto"`` path (see :func:`_tuned_choice`)
STORE_RECHECK_S = 1.0


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


def host_signature(env: Mapping) -> tuple:
    """The :func:`env_signature` that :func:`env_to_torch` of ``env`` would
    give, read off shapes and dtypes without copying anything to a device:
    tensors as they are, other values through ``np.asarray`` (python floats
    become float64, ints int64, as there)."""
    sig = []
    for nm in sorted(env):
        v = env[nm]
        if isinstance(v, torch.Tensor):
            sig.append((nm, tuple(v.shape), _dt_name(v.dtype)))
        else:
            a = np.asarray(v)
            sig.append((nm, a.shape, a.dtype.name))
    return tuple(sig)


def stacked_signature(stacked: Mapping) -> tuple:
    """Per-example signature of a batch-stacked tensor env (leading axis
    removed); a bare scalar raises."""
    sig = []
    for nm in sorted(stacked):
        shp = tuple(stacked[nm].shape)
        if not shp:
            raise ValueError(
                f"stacked env entry {nm!r} is a bare scalar; every entry "
                f"needs a leading batch axis")
        sig.append((nm, shp[1:], _dt_name(stacked[nm].dtype)))
    return tuple(sig)


def _stack_column(vals: Sequence, device) -> torch.Tensor:
    """Stack one env entry across a batch onto ``device``.

    numpy arrays and numpy scalars of one dtype and shape are stacked on the
    host and copied to the device once; tensors go through ``torch.stack``
    (differentiably); anything else is converted per element as
    :func:`env_to_torch` converts it (python floats to float64)."""
    first = vals[0]
    if isinstance(first, (np.ndarray, np.generic)):
        dt, shp = first.dtype, np.shape(first)
        if all(isinstance(v, (np.ndarray, np.generic)) and v.dtype == dt
               and np.shape(v) == shp for v in vals):
            out = np.empty((len(vals),) + shp, dtype=dt)
            for i, v in enumerate(vals):
                out[i] = v
            return torch.from_numpy(out).to(device)
    return torch.stack([
        torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                        device=device) for v in vals])


def stack_envs(envs: Union[Mapping, Sequence[Mapping]], device) -> dict:
    """A batch as one tensor env on ``device``: a sequence of same-signature
    envs is stacked column by column; a stacked dict (every entry with a
    leading batch axis) is moved as :func:`env_to_torch` moves an env."""
    if isinstance(envs, Mapping):
        return env_to_torch(envs, device)
    envs = list(envs)
    if not envs:
        raise ValueError("run_batch needs at least one env")
    return {k: _stack_column([e[k] for e in envs], device) for k in envs[0]}


@dataclass(frozen=True)
class ExecutorKey:
    """Full identity of one compiled specialization."""

    plan: str  # structural plan hash
    env: tuple  # env_signature
    backend: str  # resolved: "torch" | "hopper" (sharded: as requested)
    blocks: Optional[tuple]  # (block_rows, block_cols, block_inner) | None
    device: str  # torch device the executor runs on (sharded: the outputs')
    #: sharded entries only (:mod:`repro_torch.shard`): the mesh's
    #: ``(((axis, size), ...), (device, ...))``
    mesh: Optional[tuple] = None
    #: sharded entries only: the partition ``((level, axis, shards), ...)``
    partition: Optional[tuple] = None
    #: sharded entries only: the requested halo strategy
    halo: Optional[str] = None
    #: K1 entries only: the operands it reads without their zero pad
    #: (:func:`~repro_torch.lowering.emit.pad_key`)
    pads: tuple = ()


# ---------------------------------------------------------------------------
# compiled executor
# ---------------------------------------------------------------------------


class _RaceFunction(torch.autograd.Function):
    """Autograd node of one executor call (``batched``: of one
    ``run_batch``); port of the reference's ``make_custom_vjp``.  ``apply``
    tracks positional tensors only, so the env comes flattened in ``names``
    order and the outputs go back as a tuple in ``ex.out_names`` order.

    The backward is differentiable: under ``create_graph`` grad is on while
    it runs, so each adjoint plan's run is itself a ``_RaceFunction`` node
    (and the refused specs' autograd fallback keeps its graph).  A
    first-order backward runs with grad off, so the adjoint plans take the
    bare core."""

    @staticmethod
    def forward(ctx, ex, names, batched, *tensors):
        ctx.ex, ctx.names, ctx.batched = ex, names, batched
        ctx.save_for_backward(*tensors)
        env = dict(zip(names, tensors))
        outs = ex._batch_core(env) if batched else ex._core(env)
        return tuple(outs[nm] for nm in ex.out_names)

    @staticmethod
    def backward(ctx, *gouts):
        from .adjoint import backward

        ex, names = ctx.ex, ctx.names
        wrt = [nm for nm, need in zip(names, ctx.needs_input_grad[3:])
               if need]
        grads = backward(ex.plan.program, dict(zip(names, ctx.saved_tensors)),
                         dict(zip(ex.out_names, gouts)), wrt=wrt,
                         batched=ctx.batched)
        return (None, None, None) + tuple(grads[nm] for nm in names)


class CompiledRace:
    """One specialization of a plan: the torch evaluator or the kernel's
    wrapper, built once per :class:`ExecutorKey`.  ``calls`` counts runs,
    ``batch_calls`` batched runs, and ``kernel_launches`` the Hopper kernel
    launches among them.  ``pads`` (``{name: ((lo, hi) per dimension)}``,
    K1 alone): those entries of an env come without that zero pad around
    their shape in ``env_sig``, and the kernel reads them in place; such an
    executor records no graph."""

    def __init__(self, plan: Plan, env_sig: tuple, selection: Selection, *,
                 device: torch.device, block_rows: int = 0,
                 block_cols: int = 0, block_inner: int = 0, pads=()):
        self.plan = plan
        self.env_sig = env_sig
        self.selection = selection
        self.backend = selection.backend
        self.device = device
        self.pads = dict(pads)
        self.calls = 0
        self.batch_calls = 0
        self.out_names = tuple(dict.fromkeys(st.lhs.name for st in plan.body))
        self._plan_h = plan_hash(plan)
        with _obs.span("lower", plan=self._plan_h, backend=self.backend):
            if self.backend == "hopper":
                from ..lowering.emit import specialize_stencil

                self.spec = specialize_stencil(
                    plan, {nm: shp for nm, shp, _ in env_sig},
                    {nm: dt for nm, _, dt in env_sig}, block_rows=block_rows,
                    block_cols=block_cols, block_inner=block_inner,
                    pads=self.pads)
                self._core = self.spec.apply
                self._batch_core = self.spec.apply_batch
            else:
                from .codegen import (build_batched_evaluator,
                                      build_plan_evaluator, interior)

                self.spec = None
                plan_run = build_plan_evaluator(plan)
                self._core = lambda env: interior(plan, plan_run(env))
                self._batch_core = build_batched_evaluator(plan)

    @property
    def kernel_launches(self) -> int:
        return self.spec.launches if self.spec is not None else 0

    def _call(self, env: Mapping, batched: bool, summed: bool) -> dict:
        """The core, through :class:`_RaceFunction` when autograd records
        and some input requires grad; the primal values are the bare
        core's either way.  ``summed`` (:meth:`run_sum`) takes the summed
        kernel where no graph is recorded."""
        if torch.is_grad_enabled() and any(v.requires_grad
                                           for v in env.values()):
            if self.pads:
                raise ValueError("an executor that reads operands without "
                                 "their pad records no graph")
            names = tuple(nm for nm, _, _ in self.env_sig)
            outs = _RaceFunction.apply(self, names, batched,
                                       *(env[nm] for nm in names))
            return dict(zip(self.out_names, outs))
        if summed and self.spec is not None:
            return self.spec.apply_sum(env, batched)
        return self._batch_core(env) if batched else self._core(env)

    def run(self, env: Mapping) -> dict:
        """Execute; returns interior-convention outputs."""
        return self._run(env, False, False)

    __call__ = run

    def run_batch(self, envs: Union[Mapping, Sequence[Mapping]]) -> dict:
        """Run a batch of same-signature examples in one call.

        ``envs`` is a sequence of envs (stacked here, see
        :func:`stack_envs`) or a stacked dict whose every entry carries a
        leading batch axis (scalars as ``(B,)``).  Returns ``{output name:
        (B, ...) tensor}`` with ``out[name][b] == run(envs[b])[name]``: on
        ``"hopper"`` one kernel launch (per 65,535 examples), on
        ``"torch"`` the vmapped evaluator."""
        return self._run(stack_envs(envs, self.device), True, False)

    def run_sum(self, env: Mapping, batched: bool = False) -> dict:
        """What a caller that sums each output over its every point (a
        scalar's adjoint, :func:`~.adjoint.finalize_adjoint`) needs, counted
        as a :meth:`run` (``batched``: a :meth:`run_batch` of a stacked
        env): on ``"hopper"`` the summed kernel's partials, ``(n_tiles,)``
        (``(B, n_tiles)``) in float64
        (:meth:`~repro_torch.lowering.emit.LoweredStencil.apply_sum`); on
        ``"torch"``, and where autograd records a graph, the outputs
        themselves.  Either sums to the same value over its trailing
        axes."""
        return self._run(stack_envs(env, self.device) if batched else env,
                         batched, True)

    def _run(self, env: Mapping, batched: bool, summed: bool) -> dict:
        """Count the call and span it (obs on, or the profiler recording),
        and with obs on count it in the registry: the first call pays the
        kernel's build (nvcc, when its library is not on disk yet) and
        load, its "compile" span; every later one is a "run"."""
        if batched:
            self.batch_calls += 1
        else:
            self.calls += 1
        if not _obs.tracing():  # the RACE_OBS=0 fast path: two flag reads
            return self._call(env, batched, summed)
        n = self.batch_calls if batched else self.calls
        labels = {"batch": "1"} if batched else {}
        with _obs.span("compile" if n == 1 else "run", plan=self._plan_h,
                       backend=self.backend, **labels):
            out = self._call(env, batched, summed)
        if _obs.enabled():
            _obs.counter("race_executor_batch_runs_total" if batched
                         else "race_executor_runs_total", plan=self._plan_h,
                         backend=self.backend).inc()
        return out

    @property
    def core_fn(self):
        """The raw primal core (``env -> interior outputs``), without the
        autograd wrapper."""
        return self._core

    def cache_info(self) -> dict:
        return dict(backend=self.backend, calls=self.calls,
                    batch_calls=self.batch_calls,
                    kernel_launches=self.kernel_launches)

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
    """Thread-safe LRU of :class:`CompiledRace` executors (and the sharded
    :class:`~repro_torch.shard.ShardedRace`).  The build happens under the
    lock, so concurrent first calls make exactly one executor; the lock is
    reentrant because a sharded executor's builder compiles its per-shard
    local executors through this cache."""

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = _env_cache_size() if maxsize is None else maxsize
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def get_or_build(self, key: ExecutorKey,
                     builder: Callable[[], CompiledRace]) -> CompiledRace:
        hit = True
        evicted = []
        with self._lock:
            ex = self._entries.get(key)
            if ex is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
            else:
                hit = False
                self.stats.misses += 1
                ex = self._entries[key] = builder()
                while len(self._entries) > self.maxsize:
                    old_key, _ = self._entries.popitem(last=False)
                    evicted.append(old_key)
                    self.stats.evictions += 1
        # telemetry outside the lock: the JSONL event sink does file I/O and
        # must not serialize concurrent cache lookups
        if _obs.enabled():
            _obs.counter("race_executor_cache_total",
                         event="hit" if hit else "miss",
                         plan=key.plan).inc()
            _obs.gauge("race_executor_cache_size").set(len(self._entries))
            if not hit:
                _obs.event("executor_build", plan=key.plan,
                           backend=key.backend, blocks=key.blocks,
                           device=key.device)
            self._emit_evictions(evicted)
        return ex

    def _emit_evictions(self, evicted: list) -> None:
        for old in evicted:
            _obs.counter("race_executor_cache_total", event="evict",
                         plan=old.plan).inc()
            _obs.event("executor_evict", plan=old.plan, backend=old.backend,
                       currsize=len(self._entries), maxsize=self.maxsize)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats = CacheStats()
        if _obs.enabled():
            _obs.gauge("race_executor_cache_size").set(0)

    def keys(self) -> list:
        """The cached :class:`ExecutorKey` s, least recently used first."""
        with self._lock:
            return list(self._entries)

    def executors(self) -> list:
        """The cached executors, least recently used first."""
        with self._lock:
            return list(self._entries.values())

    def stats_snapshot(self) -> dict:
        """Hit/miss/eviction counts read together under the lock."""
        with self._lock:
            return self.stats.snapshot()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: ExecutorKey) -> bool:
        return key in self._entries

    def resize(self, maxsize: int) -> None:
        """Set the capacity, evicting least recently used entries if it
        shrinks."""
        evicted = []
        with self._lock:
            self.maxsize = maxsize
            while len(self._entries) > maxsize:
                old_key, _ = self._entries.popitem(last=False)
                evicted.append(old_key)
                self.stats.evictions += 1
        if _obs.enabled():
            _obs.gauge("race_executor_cache_size").set(len(self._entries))
            self._emit_evictions(evicted)

    def cache_info(self) -> dict:
        """Stats plus the capacity (``RACE_EXECUTOR_CACHE_SIZE``), the
        entry count, the distinct devices keyed and how many entries are
        sharded executors (mesh-bearing keys from
        :mod:`repro_torch.shard`)."""
        with self._lock:
            return dict(maxsize=self.maxsize, currsize=len(self._entries),
                        devices=sorted({k.device for k in self._entries}),
                        sharded=sum(1 for k in self._entries
                                    if k.mesh is not None),
                        **self.stats.snapshot())


_CACHE = ExecutorCache()


def executor_cache() -> ExecutorCache:
    """The process-wide cache (shared by every ``RaceResult.run``)."""
    return _CACHE


def cache_stats() -> dict:
    return _CACHE.stats_snapshot()


def clear_cache() -> None:
    _CACHE.clear()


def configure_cache(maxsize: int) -> None:
    """Resize the process-wide cache (evicts LRU entries if shrinking)."""
    _CACHE.resize(maxsize)


def _resolve(plan: Plan, backend: str, dtypes: tuple) -> Selection:
    """select_backend memoized per plan instance and request (the probe is
    pure analysis), as the reference's; a refusal is not memoized."""
    memo = kernel_memo(plan).setdefault("selection", {})
    sel = memo.get((backend, dtypes))
    if sel is None:
        sel = memo[(backend, dtypes)] = select_backend(plan, backend, dtypes)
    return sel


def operand_dtypes(plan: Plan, sig: tuple) -> tuple:
    """The dtype names the signature gives the plan's kernel operands (what
    the Hopper probe checks)."""
    arrays = kernel_analysis(plan).arrays
    return tuple(dt for nm, _, dt in sig if nm in arrays)


def _tuned_choice(plan: Plan, sig: tuple, device: torch.device,
                  dtypes: tuple, batch: int = 0) -> Optional[tuple]:
    """The persistent autotuning store's (:mod:`repro_torch.tuning`) record
    for this (plan, env signature) on this device's runtime fence, as
    ``(backend, blocks)`` (``blocks`` None for ``"torch"``), or None — and
    *never* raises: a corrupt or stale store must degrade to the chooser,
    not take the serving path down.  A ``"hopper"`` record counts only
    where the probe still passes for the plan and ``dtypes``; its blocks
    are ``(0, 0, 0)``, the chooser's tile, where the chooser cannot honour
    the stored ones.  ``batch > 1`` (the serving runtime's coalesced
    dispatch) prefers the record measured at or nearest that batch size
    (:func:`~repro_torch.tuning.store.plan_batch_choice`) over the
    per-call one.

    Runs on every ``backend="auto"`` call, so the key (JSON of the
    signature plus the fence) and the record's reading are memoized per
    plan instance, signature and device, and the store (one ``os.stat``
    freshness check, which keeps other processes' records live) is asked
    again only :data:`STORE_RECHECK_S` after the last time: on a network
    file system (9p) that ``stat`` cost 100 µs a call beside an H100 and
    slowed the launch after it (``PERF.md`` §6).  A record written since
    is picked up on the first call after that."""
    try:
        from ..tuning.store import (plan_batch_choice, plan_choice,
                                    record_key, runtime_fence)

        batch = batch if batch > 1 else 0
        memo = kernel_memo(plan).setdefault("tuning", {})
        entry = memo.get((sig, str(device), batch))
        now = time.monotonic()
        if entry is None:  # [key, fence, last check, the choice, reading]
            fence = runtime_fence(device)
            entry = memo[(sig, str(device), batch)] = [record_key(
                "plan", plan_hash(plan), sig, fence), fence, None, None,
                None]
        elif now - entry[2] < STORE_RECHECK_S:
            return entry[4]
        entry[2] = now
        choice = None
        if batch:
            choice = plan_batch_choice(plan_hash(plan), sig, batch,
                                       fence=entry[1])
        if choice is None:
            choice = plan_choice(entry[0])
        if choice is not entry[3]:
            entry[3:] = [choice, _read_choice(plan, choice, dtypes)]
        return entry[4]
    except Exception:
        return None


def _read_choice(plan: Plan, choice, dtypes: tuple) -> Optional[tuple]:
    """``(backend, blocks)`` of a stored choice dict (see
    :func:`_tuned_choice`), or None for no usable record."""
    if not isinstance(choice, dict):
        return None
    if choice.get("backend") == "torch":
        return ("torch", None)
    if (choice.get("backend") != "hopper"
            or _resolve(plan, "auto", dtypes).backend != "hopper"):
        return None
    from ..tuning.space import Config, blocks_refusal

    try:
        tuned = Config.from_dict(choice)
    except (TypeError, ValueError):
        return ("hopper", (0, 0, 0))  # a bad record: the chooser's tile
    if blocks_refusal(plan, tuned):
        return ("hopper", (0, 0, 0))
    return ("hopper", (tuned.block_rows, tuned.block_cols,
                       tuned.block_inner))


def compile_plan(plan: Plan, env: Union[Mapping, tuple],
                 backend: Optional[str] = None, *, device=None,
                 block_rows: int = 0, block_cols: int = 0,
                 block_inner: int = 0,
                 cache: Optional[ExecutorCache] = None,
                 batch: int = 0, pads=None) -> CompiledRace:
    """Fetch (or build) the executor for this (plan, tensor env) pairing.

    ``env`` is a tensor env, whose tensors fix the device, or a precomputed
    signature (:func:`env_signature`, :func:`stacked_signature`) with the
    ``device`` given.  ``backend=None`` resolves to ``$RACE_BACKEND``
    (default ``"auto"``).  ``"auto"`` consults the persistent autotuning
    store first (:func:`_tuned_choice`): a measured, gated winner recorded
    for this (plan hash, signature, card, torch and CUDA versions) — by this
    or any earlier process — supplies the backend and K1's block overrides.
    A stored tile the chooser cannot honour (larger than an extent, rings
    over shared memory) falls back to the chooser's tile on the same
    backend.  ``batch > 1`` names the coalesced batch the executor will
    run, so ``"auto"`` prefers the record measured at (or nearest) that
    batch size.  Without a record, ``"auto"`` takes the kernel when the probe
    passes for the plan and the env's dtypes.  Explicit ``"torch"`` /
    ``"hopper"`` requests bypass the store (that is how the tuner measures).
    The selection is memoized per plan and request, so its telemetry fires
    once, not per run.  ``pads`` (``{name: ((lo, hi) per dimension)}``):
    where the selection is K1, the executor's env brings those entries
    without that zero pad around the signature's shape
    (:attr:`CompiledRace.pads`); the ``"torch"`` evaluator takes no pads,
    and its executor has none."""
    if isinstance(env, tuple):
        if device is None:
            raise ValueError("compile_plan on a signature needs device=")
        sig, device = env, torch.device(device)
        if device.type == "cuda" and device.index is None:
            # as a tensor made on "cuda" reports it: one key for both
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        sig = env_signature(env)
        devices = {v.device for v in env.values()}
        if len(devices) != 1:
            raise ValueError(f"env tensors lie on several devices: "
                             f"{devices}")
        (device,) = devices
    base = operand_dtypes(plan, sig)
    backend = backend or default_backend()
    blocks = (block_rows, block_cols, block_inner)
    if backend == "auto":
        tuned = _tuned_choice(plan, sig, device, base, batch)
        if tuned is not None:
            backend, tuned_blocks = tuned
            if tuned_blocks is not None:
                try:
                    return _executor(plan, sig, _resolve(plan, "hopper", base),
                                     tuned_blocks, device, cache, pads)
                except ValueError:
                    pass  # e.g. hopper-smem: the chooser's tile below
                blocks = (0, 0, 0)
    return _executor(plan, sig, _resolve(plan, backend, base), blocks, device,
                     cache, pads)


def _executor(plan: Plan, sig: tuple, sel: Selection, blocks: tuple,
              device, cache: Optional[ExecutorCache],
              pads=None) -> CompiledRace:
    """The cached executor of one resolved selection, block config and (on
    K1) set of operands read without their zero pad."""
    hopper = sel.backend == "hopper"
    if hopper and pads:
        from ..lowering.emit import pad_key

        pads = pad_key(pads)
    else:
        pads = ()
    key = ExecutorKey(plan_hash(plan), sig, sel.backend,
                      blocks if hopper else None, str(device), pads=pads)
    c = cache if cache is not None else _CACHE
    return c.get_or_build(key, lambda: CompiledRace(
        plan, sig, sel, device=device, block_rows=blocks[0],
        block_cols=blocks[1], block_inner=blocks[2], pads=pads))
