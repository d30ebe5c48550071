"""Own copy of ``repro/obs/spans.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Lightweight phase spans: nested wall-time timing into span histograms.

``obs.span("detect")`` times a ``with`` block and records the duration into
the ``race_span_seconds`` histogram labeled with the *leaf* span name plus
the full nesting ``path`` (thread-local stack), so both "total time in
detect" and "detect inside race inside autotune" views exist:

    with obs.span("race"):
        with obs.span("detect"):       # span=detect, path=race/detect
            ...

Besides the histogram aggregate, every completed span also lands in a
bounded :class:`SpanLog` as one *timeline record* — leaf name, nesting
path, wall-clock start offset from the process origin, duration, and the
recording thread — which is exactly the information a Chrome-trace /
Perfetto timeline needs (:mod:`repro_torch.obs.trace` renders it).

When observability is disabled, ``obs.span`` returns one shared no-op
context manager — no allocation, no clock read, no stack touch — which is
the whole overhead story of the ``RACE_OBS=0`` path.

The port's own addition: while ``torch.profiler`` records, a span also
opens a profiler range named ``race.<span>`` (:func:`profiler_range`), so
the spans sit on the device trace's clock, beside the kernels they
launched; with obs off the range alone is the span.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import torch

#: default SpanLog capacity (records, not bytes); newest win
DEFAULT_SPAN_RING = 16384

#: process time origin: perf_counter reference plus the wall-clock epoch it
#: corresponds to, captured once at import so every span record's ``ts_us``
#: offset is on one shared, monotonic axis (and convertible to wall time)
_ORIGIN_PERF = time.perf_counter()
_ORIGIN_EPOCH = time.time()

_stack = threading.local()

#: a span's name in a ``torch.profiler`` trace is this prefix and its own
RANGE_PREFIX = "race."

# the profiler's cheap range (``record_function`` costs several times as
# much, and as much again with the profiler off); older torch lacks it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def profiler_range(name: str):
    """A context manager that records the range ``race.<name>`` in the
    ``torch.profiler`` trace being taken."""
    return _RANGE(RANGE_PREFIX + name)


def _path_of(name: str) -> str:
    stack = getattr(_stack, "names", None)
    if stack is None:
        stack = _stack.names = []
    return "/".join(stack + [name])


def current_path() -> str:
    """The active nesting path ("" at top level) — introspection for tests
    and for events that want to record which phase emitted them."""
    stack = getattr(_stack, "names", None)
    return "/".join(stack) if stack else ""


class SpanLog:
    """Bounded ring of completed-span timeline records (thread-safe).

    One record per finished span::

        {"name": "lower", "path": "race/lower", "ts_us": 1234.5,
         "dur_us": 88.2, "tid": 140..., "thread": "MainThread",
         "labels": {"plan": "ab12...", "backend": "xla"}}

    ``ts_us`` is microseconds since the process time origin (one shared
    monotonic axis across threads); :func:`epoch_of_origin` anchors it to
    wall-clock time for cross-process correlation.
    """

    def __init__(self, ring: int = DEFAULT_SPAN_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self.dropped = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


def epoch_of_origin() -> float:
    """Wall-clock (``time.time``) epoch of the ``ts_us = 0`` origin."""
    return _ORIGIN_EPOCH


class Span:
    """One timed phase; records on exit (exceptions still record).  ``rng``,
    where given, is a profiler range (:func:`profiler_range`) held open
    around the timed block."""

    __slots__ = ("name", "labels", "registry", "log", "t0", "path",
                 "seconds", "rng")

    def __init__(self, name: str, registry, labels: dict, log=None,
                 rng=None):
        self.name = name
        self.registry = registry
        self.labels = labels
        self.log = log
        self.rng = rng
        self.t0 = 0.0
        self.path = ""
        self.seconds = None

    def __enter__(self) -> "Span":
        if self.rng is not None:
            self.rng.__enter__()
        self.path = _path_of(self.name)
        _stack.names.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.rng is not None:
            self.rng.__exit__(*exc)
        dt = t1 - self.t0
        self.seconds = dt
        stack = _stack.names
        if stack and stack[-1] == self.name:
            stack.pop()
        self.registry.histogram(
            "race_span_seconds", span=self.name, path=self.path,
            **self.labels).observe(dt)
        if self.log is not None:
            th = threading.current_thread()
            self.log.record(dict(
                name=self.name, path=self.path,
                ts_us=(self.t0 - _ORIGIN_PERF) * 1e6, dur_us=dt * 1e6,
                tid=th.ident, thread=th.name,
                labels={str(k): str(v) for k, v in self.labels.items()}))


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()
