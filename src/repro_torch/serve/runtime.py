"""Async serving runtime of the PyTorch port: plan-hash dynamic batching
over the executor layer.

Port of ``repro/serve/runtime.py``, with the same coalescing, window,
backpressure and shutdown contract, the same ``RACE_SERVE_*`` knobs and the
same telemetry.  RACE's detection eliminates redundant computation *inside*
one program; the executor cache eliminates redundant specialization (and
the kernel library directory redundant nvcc runs) across calls.  This
module eliminates the last redundancy on the serving path: redundant
**dispatch**.  Concurrent ``run`` requests for the same specialization —
the same ``(plan hash, env signature, backend)`` — are coalesced into one
``run_batch`` call: on ``"hopper"`` one K1 launch with the batch on the
grid's second axis, so N requests pay one launch and one host dispatch
instead of N.

Shape of the machinery:

  * :meth:`ServeRuntime.submit` appends the request to a per-specialization
    group queue and returns a ``concurrent.futures.Future``; the caller
    blocks only if and when it wants the result (:meth:`ServeRuntime.run`
    is the blocking convenience).  The group key's signature is read off the
    submitted env's shapes and dtypes by the rule ``env_to_torch`` applies
    (a python float is float64): nothing is copied to the device on the
    caller's thread.
  * A worker pool (default: one worker per CUDA device; one on the CPU)
    drains group queues.  The first request of a group opens a **batching
    window** (``RACE_SERVE_WINDOW_US``): the worker holds the batch open
    until ``RACE_SERVE_MAX_BATCH`` requests have coalesced or the window
    expires, then dispatches once — batch 1 through ``run``, larger through
    ``run_batch`` (numpy envs: one host stack and one host-to-device copy
    per env entry) — and fans the stacked outputs back out to the futures
    as numpy: one device-to-host copy per output, then host slicing.  A
    group sits in the ready queue at most once (the ``scheduled`` flag), so
    its requests are drained exactly once, by exactly one worker per batch.
  * **Backpressure** is structural, not implicit: when the total queued
    requests reach ``RACE_SERVE_QUEUE``, ``submit`` raises
    :class:`ServeRejected` (``code="queue-full"``) instead of growing the
    queue without bound; a closed runtime rejects with ``code="shutdown"``.
  * ``backend="auto"`` dispatch consults the tuning store's *batch-aware*
    records (:func:`repro_torch.tuning.store.plan_batch_choice`): a config
    measured at (or nearest to) the actual coalesced batch size wins over
    the per-call record.
  * A failure — a K1 build or launch included — reaches every future of
    its batch; nothing is retried on another backend or device.

Knobs (all also constructor arguments, documented in README):

    RACE_SERVE_MAX_BATCH   max requests per coalesced dispatch  (default 8)
    RACE_SERVE_WINDOW_US   batching window in microseconds      (default 2000)
    RACE_SERVE_QUEUE       bound on total queued requests       (default 256)
    RACE_SERVE_WORKERS     worker threads                       (default
                           ``torch.cuda.device_count()`` on the card, 1 on
                           the CPU)

Telemetry (``RACE_OBS=1``): ``race_serve_queue_depth`` gauge,
``race_serve_batch_size`` histogram, ``serve_admit``/``serve_reject``
events, and a ``serve`` span around every coalesced dispatch (host time:
it ends with the device-to-host copy of the outputs).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Mapping, Optional, Sequence, Union

import torch

from .. import obs as _obs
from ..core.depgraph import Plan
from ..core.executor import (CompiledRace, compile_plan, default_backend,
                             env_to_torch, host_signature, plan_hash,
                             resolve_device)

ENV_MAX_BATCH = "RACE_SERVE_MAX_BATCH"
ENV_WINDOW_US = "RACE_SERVE_WINDOW_US"
ENV_QUEUE = "RACE_SERVE_QUEUE"
ENV_WORKERS = "RACE_SERVE_WORKERS"

#: batch-size histogram buckets (powers of two up to the queue bound)
BATCH_EDGES = (1, 2, 4, 8, 16, 32, 64, 128)


def _env_int(var: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(var, "").strip()
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{var}={raw!r} is not an integer") from None
    if v < lo:
        raise ValueError(f"{var} must be >= {lo}, got {v}")
    return v


class ServeRejected(RuntimeError):
    """Structured rejection: the runtime refused to queue a request.

    ``code`` is machine-readable — ``"queue-full"`` (backpressure: the
    bounded queue is at capacity; retry with backoff) or ``"shutdown"``
    (the runtime is closed / closing without flush; do not retry here).
    """

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class _Request:
    __slots__ = ("env", "future", "t")

    def __init__(self, env: Mapping, t: Optional[float] = None):
        self.env = env
        self.future: Future = Future()
        self.t = time.monotonic() if t is None else t


class _Group:
    """All queued requests for one compiled specialization."""

    __slots__ = ("key", "plan", "plan_h", "sig", "backend", "pending",
                 "scheduled", "ex")

    def __init__(self, key: tuple, plan: Plan, plan_h: str, sig: tuple,
                 backend: str):
        self.key = key
        self.plan = plan
        self.plan_h = plan_h
        self.sig = sig
        self.backend = backend
        self.pending: deque = deque()
        self.scheduled = False  # True while a worker owns this group
        self.ex: Optional[CompiledRace] = None  # pinned executor (non-auto)


class ServeRuntime:
    """Thread-safe dynamic-batching front end over the executor cache.

    Accepts :class:`~repro_torch.core.race.RaceResult` or bare
    :class:`~repro_torch.core.depgraph.Plan` targets; every
    same-specialization request submitted within one batching window shares
    a single dispatch.  ``device=None`` means ``cuda`` and raises without a
    card; pass ``device="cpu"`` to serve on the CPU (``"hopper"`` then runs
    the tile emulator).  Use as a context manager (``close(flush=True)`` on
    exit)::

        with ServeRuntime() as rt:
            futs = [rt.submit(res, env) for env in envs]
            outs = [f.result() for f in futs]
    """

    def __init__(self, *, max_batch: Optional[int] = None,
                 window_us: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 workers: Optional[int] = None,
                 backend: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.max_batch = (max_batch if max_batch is not None
                          else _env_int(ENV_MAX_BATCH, 8))
        if window_us is None:
            window_us = float(_env_int(ENV_WINDOW_US, 2000, lo=0))
        self.window_s = max(0.0, float(window_us)) * 1e-6
        self.queue_limit = (queue_limit if queue_limit is not None
                            else _env_int(ENV_QUEUE, 256))
        if workers is None:
            workers = _env_int(ENV_WORKERS, max(1, (
                torch.cuda.device_count() if self.device.type == "cuda"
                else 1)))
        self.backend = backend  # None -> $RACE_BACKEND / "auto" per submit
        self._cond = threading.Condition()
        self._groups: "OrderedDict[tuple, _Group]" = OrderedDict()
        self._ready: deque = deque()  # groups with unclaimed pending work
        self._pending_total = 0
        self._closing = False
        self._closed = False
        self._stats = dict(submitted=0, completed=0, failed=0, rejected=0,
                           batches=0, coalesced=0, max_batch=0)
        self._workers = [
            threading.Thread(target=self._worker, name=f"race-serve-{i}",
                             daemon=True)
            for i in range(max(1, workers))]
        for w in self._workers:
            w.start()

    # -- submission ---------------------------------------------------------

    def _group_for(self, target: Union[Plan, "object"], env: Mapping,
                   backend: Optional[str]) -> tuple:
        plan = getattr(target, "plan", target)
        if not isinstance(plan, Plan):
            raise TypeError(
                f"serve target must be a Plan or RaceResult, got "
                f"{type(target).__name__}")
        b = backend or self.backend or default_backend()
        sig = host_signature(env)
        ph = plan_hash(plan)
        return (ph, sig, b), plan, ph, sig, b

    def submit(self, target, env: Mapping, *,
               backend: Optional[str] = None) -> Future:
        """Queue one request; returns a future of the output dict.

        The future resolves to the *host* (numpy) materialization of what
        ``CompiledRace.run(env)`` computes on the runtime's device — element
        ``[b]`` of the coalesced ``run_batch`` when the request rode a
        batch; bit-equal either way.  Raises :class:`ServeRejected` — it never
        blocks the caller on a full queue.
        """
        key, plan, ph, sig, b = self._group_for(target, env, backend)
        req = _Request(env)  # allocated outside the lock: hot path
        with self._cond:
            if self._closing or self._closed:
                self._stats["rejected"] += 1
                raise ServeRejected("shutdown",
                                    "serve runtime is shut down")
            if self._pending_total >= self.queue_limit:
                self._stats["rejected"] += 1
                if _obs.enabled():
                    _obs.counter("race_serve_requests_total",
                                 outcome="rejected").inc()
                    _obs.event("serve_reject", code="queue-full", plan=ph,
                               queue=self._pending_total,
                               limit=self.queue_limit)
                raise ServeRejected(
                    "queue-full",
                    f"serve queue at capacity ({self.queue_limit})")
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group(key, plan, ph, sig, b)
            g.pending.append(req)
            self._pending_total += 1
            self._stats["submitted"] += 1
            # wake workers only on a transition they care about: a group
            # becoming ready, or a window-waiting batch filling up.  A bare
            # straggler joining a half-open window needs no wakeup — the
            # window worker has a timed wait and will collect it at the
            # deadline.  (Per-submit notify_all costs a worker wakeup per
            # request, which at batch 8 rivals the dispatch being saved.)
            if not g.scheduled:
                g.scheduled = True
                self._ready.append(g)
                self._cond.notify_all()
            elif len(g.pending) >= self.max_batch:
                self._cond.notify_all()
            depth = self._pending_total
        if _obs.enabled():
            _obs.counter("race_serve_requests_total",
                         outcome="admitted").inc()
            _obs.gauge("race_serve_queue_depth").set(depth)
            _obs.event("serve_admit", plan=ph, backend=b, queue=depth)
        return req.future

    def submit_many(self, target, envs: Sequence[Mapping], *,
                    backend: Optional[str] = None) -> list:
        """Queue a burst of same-signature requests; one future per env.

        The burst form of :meth:`submit` for ingestion-side batching: one
        signature resolution, one lock acquisition, and one worker wakeup
        cover the whole burst, so per-request queue overhead stops rivaling
        the dispatch the queue exists to amortize.  Each env still becomes
        its own queued request with its own future — the worker coalesces
        across burst boundaries exactly as it does for lone submits, and
        backpressure applies to the burst atomically (all queued, or all
        rejected with :class:`ServeRejected`).

        All envs must share one signature (the first env's is trusted for
        the group key; per-request re-validation is skipped deliberately).
        A mixed-signature burst fails at dispatch and every future in the
        offending batch receives the error — it cannot corrupt results.
        """
        envs = list(envs)
        if not envs:
            return []
        key, plan, ph, sig, b = self._group_for(target, envs[0], backend)
        now = time.monotonic()
        reqs = [_Request(e, now) for e in envs]
        n = len(reqs)
        with self._cond:
            if self._closing or self._closed:
                self._stats["rejected"] += n
                raise ServeRejected("shutdown",
                                    "serve runtime is shut down")
            if self._pending_total + n > self.queue_limit:
                self._stats["rejected"] += n
                if _obs.enabled():
                    _obs.counter("race_serve_requests_total",
                                 outcome="rejected").inc(n)
                    _obs.event("serve_reject", code="queue-full", plan=ph,
                               queue=self._pending_total,
                               limit=self.queue_limit, burst=n)
                raise ServeRejected(
                    "queue-full",
                    f"serve queue cannot take a burst of {n} "
                    f"(limit {self.queue_limit})")
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group(key, plan, ph, sig, b)
            g.pending.extend(reqs)
            self._pending_total += n
            self._stats["submitted"] += n
            if not g.scheduled:
                g.scheduled = True
                self._ready.append(g)
                self._cond.notify_all()
            elif len(g.pending) >= self.max_batch:
                self._cond.notify_all()
            depth = self._pending_total
        if _obs.enabled():
            _obs.counter("race_serve_requests_total",
                         outcome="admitted").inc(n)
            _obs.gauge("race_serve_queue_depth").set(depth)
            _obs.event("serve_admit", plan=ph, backend=b, queue=depth,
                       burst=n)
        return [r.future for r in reqs]

    def run(self, target, env: Mapping, *, backend: Optional[str] = None,
            timeout: Optional[float] = None) -> dict:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(target, env, backend=backend).result(timeout)

    def warmup(self, items: Sequence, **kw) -> list:
        """Eagerly build executors (and their K1 libraries) before traffic.

        Delegates to :func:`repro_torch.serve.warm.warmup` for the executor
        builds on this runtime's device (see there for the item forms
        accepted — (plan | RaceResult, env | signature) pairs), then routes
        one ``max_batch`` burst per item through the queue — so the batched
        path has run once before real traffic coalesces (otherwise the first full batch pays
        it) — followed by one priming *single* request, so the first real
        request finds the whole submit -> worker -> dispatch path hot, not
        just the executor.  The single goes last deliberately: a lone
        first request takes the single-dispatch path, and warmup should
        leave exactly that path hottest.  Each report gains ``queue_ms``
        (the priming round trip, including this runtime's batching window)
        and ``batch_ms`` (the burst round trip) when batching is enabled.
        """
        from .warm import synthetic_env
        from .warm import warmup as _warmup

        kw.setdefault("device", self.device)
        reports = _warmup(items, **kw)
        backend = kw.get("backend")
        for (target, env), rep in zip(items, reports):
            if isinstance(env, tuple):
                env = synthetic_env(env)
            if self.max_batch > 1:
                t1 = time.perf_counter()
                for f in self.submit_many(target, [env] * self.max_batch,
                                          backend=backend):
                    f.result()
                rep["batch_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
            t0 = time.perf_counter()
            self.run(target, env, backend=backend)
            rep["queue_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return reports

    # -- worker loop --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._ready and not self._closing:
                    self._cond.wait()
                if not self._ready:
                    return  # closing, queue drained
                g = self._ready.popleft()
                # batching window: hold the batch open for stragglers, but
                # never past the deadline the *oldest* request started
                if self.window_s > 0 and g.pending:
                    deadline = g.pending[0].t + self.window_s
                    while (len(g.pending) < self.max_batch
                           and not self._closing):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                n = min(self.max_batch, len(g.pending))
                take = [g.pending.popleft() for _ in range(n)]
                self._pending_total -= n
                if g.pending:
                    self._ready.append(g)  # leftovers: keep the group owned
                    self._cond.notify_all()
                else:
                    g.scheduled = False
                depth = self._pending_total
            if _obs.enabled():
                _obs.gauge("race_serve_queue_depth").set(depth)
            if take:
                self._execute(g, take)

    def _executor(self, g: _Group, batch: int) -> CompiledRace:
        """Resolve the executor for this group at this coalesced size.

        The ``"auto"`` path prefers a *batch-aware* tuning record — the
        config measured at (or nearest) this batch size — over the per-call
        record; ``compile_plan`` reads both through its memoized store
        consult, and a stale/infeasible stored config degrades to the
        chooser's tile on the same backend rather than failing the batch.

        An explicit backend pins the resolved executor on the group: the
        key fixes (plan, signature, backend), so re-resolving through the
        cache every batch only buys lock traffic on the dispatch hot path.
        ``"auto"`` stays unpinned — its answer may change with batch size
        and with what the tuner has learned since the last batch.  Nothing
        here catches a kernel's build or launch.
        """
        if g.ex is not None:
            return g.ex
        ex = compile_plan(g.plan, g.sig, g.backend, device=self.device,
                          batch=batch)
        if g.backend != "auto":
            g.ex = ex
        return ex

    def _execute(self, g: _Group, take: list) -> None:
        n = len(take)
        try:
            ex = self._executor(g, n)
            if not _obs.enabled():
                results = self._dispatch(ex, take, self.device)
            else:
                with _obs.span("serve", plan=g.plan_h, backend=ex.backend,
                               batch=str(n)):
                    results = self._dispatch(ex, take, self.device)
                _obs.histogram("race_serve_batch_size",
                               edges=BATCH_EDGES).observe(n)
        except Exception as e:  # noqa: BLE001 - delivered per request
            with self._cond:
                self._stats["failed"] += n
            for r in take:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        with self._cond:
            self._stats["completed"] += n
            self._stats["batches"] += 1
            if n > 1:
                self._stats["coalesced"] += n
            self._stats["max_batch"] = max(self._stats["max_batch"], n)
        for r, out in zip(take, results):
            r.future.set_result(out)

    @staticmethod
    def _dispatch(ex: CompiledRace, take: list, device) -> list:
        """Execute one coalesced batch; returns per-request host outputs.

        Futures resolve to *numpy* outputs on both paths: a serving response
        is host data by the time anyone can use it, and host-side fan-out of
        the stacked batch costs one device-to-host copy per output —
        per-request device slicing would cost a copy per (request, output)
        pair.  The batch's inputs are stacked by ``run_batch`` (numpy envs:
        on the host, then one host-to-device copy per entry).
        """
        if len(take) == 1:
            out = ex.run(env_to_torch(take[0].env, device))
            return [{k: v.cpu().numpy() for k, v in out.items()}]
        stacked = ex.run_batch([r.env for r in take])
        host = {k: v.cpu().numpy() for k, v in stacked.items()}
        return [{k: host[k][b] for k in host} for b in range(len(take))]

    # -- lifecycle / introspection ------------------------------------------

    def stats(self) -> dict:
        """Atomic counters snapshot plus current queue shape."""
        with self._cond:
            return dict(self._stats, queue_depth=self._pending_total,
                        groups=len(self._groups),
                        workers=len(self._workers),
                        max_batch_limit=self.max_batch,
                        window_us=self.window_s * 1e6,
                        queue_limit=self.queue_limit)

    def close(self, flush: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop the runtime.  ``flush=True`` serves everything already
        queued first; ``flush=False`` fails queued futures with
        :class:`ServeRejected` (``code="shutdown"``) immediately.  Either
        way new submissions are rejected from this point on."""
        dropped = []
        with self._cond:
            if self._closed:
                return
            self._closing = True
            if not flush:
                for g in self._groups.values():
                    while g.pending:
                        dropped.append(g.pending.popleft())
                        self._pending_total -= 1
                    g.scheduled = False
                self._ready.clear()
                self._stats["rejected"] += len(dropped)
            self._cond.notify_all()
        for r in dropped:
            if not r.future.done():
                r.future.set_exception(
                    ServeRejected("shutdown", "serve runtime closed"))
        for w in self._workers:
            w.join(timeout)
        self._closed = True

    def __enter__(self) -> "ServeRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))
