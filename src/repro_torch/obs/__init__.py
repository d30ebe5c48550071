"""RACE observability for the PyTorch port: metrics, spans, and structured
decision events.

Own copy of ``repro/obs/__init__.py`` (the port imports nothing of
``repro``), with the same knobs and names; only :func:`run_stamp` is the
port's own: it stamps the torch device and the torch and CUDA versions.

One process-wide state (registry + event log) behind a single enabled flag:

    RACE_OBS=1            enable instrumentation (default: off)
    RACE_OBS_EVENTS=PATH  also append decision events to a JSONL file
    RACE_OBS_RING=N       in-memory event ring capacity (default 4096)

Public surface (every call is safe — and near-free — when disabled):

    obs.enabled()                  -> bool (one attribute read)
    obs.tracing()                  -> bool: obs on, or torch.profiler recording
    obs.span("detect", **labels)   -> context manager timing a phase
    obs.event("kind", **fields)    -> structured decision event
    obs.counter/gauge/histogram()  -> registry series (get-or-create)
    obs.snapshot(label_filter=..)  -> plain-dict metrics view (+ events)
    obs.render_prometheus()        -> Prometheus text exposition
    obs.dump(path)                 -> {"stamp", "metrics", "events"} JSON
    obs.configure(...) / reset()   -> programmatic control / re-read env

Design rule, mirrored from the capability probe's "never silent" contract:
every decision the pipeline computes — fallback reasons, refusals,
diagnostics, gate verdicts, cache evictions — is *emitted*, not discarded,
the moment observability is on.  The disabled path is a no-op by
construction: ``span`` returns a shared no-op object, ``event`` and the
metric helpers return before building anything, so serving pays one boolean
attribute read per call site (a span two: the profiler's flag besides).

The port's spans are also ``torch.profiler`` ranges, ``race.<span>``, with
obs on or off, whenever the profiler records: a trace of any caller's code
shows which layer of the port the host was in, on the device trace's
clock, at a few microseconds a range.  With obs off that is all a span
does (no registry, no span log).  :data:`PORT_SPANS` and :data:`PORT_METRICS`
are the port's own spans and metrics, which the reference has no
counterpart of.
"""
from __future__ import annotations

import json
import os
import threading

from torch.autograd import profiler as _profiler

from .events import DEFAULT_RING, EventLog, load_jsonl
from .metrics import DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry
from .spans import (DEFAULT_SPAN_RING, NOOP_SPAN, RANGE_PREFIX, Span,
                    SpanLog, current_path, epoch_of_origin, profiler_range)

__all__ = [
    "enabled", "configure", "reset", "span", "event", "events",
    "counter", "gauge", "histogram", "metrics", "event_log",
    "snapshot", "span_summary", "span_records", "span_log",
    "render_prometheus", "render_json",
    "dump", "run_stamp", "current_path", "load_jsonl", "epoch_of_origin",
    "Registry", "Counter", "Gauge", "Histogram", "EventLog", "SpanLog",
    "DEFAULT_BUCKETS", "DEFAULT_RING", "DEFAULT_SPAN_RING",
    "ENV_OBS", "ENV_EVENTS", "ENV_RING", "ENV_SPANS", "OBS_SCHEMA",
]

ENV_OBS = "RACE_OBS"
ENV_EVENTS = "RACE_OBS_EVENTS"
ENV_RING = "RACE_OBS_RING"
ENV_SPANS = "RACE_OBS_SPANS"

#: schema version stamped on dumps and benchmark JSON artifacts
OBS_SCHEMA = 1

#: the port's own spans, which the reference does not have: ``entry`` (a
#: whole ``RaceResult.run`` / ``run_batch``), ``inputs`` (its device and
#: input moves), ``lookup`` (choosing its executor) and ``k1`` (K1's
#: wrapper, ``LoweredStencil``: checks, launch or emulator, cast)
PORT_SPANS = ("entry", "inputs", "lookup", "k1")
#: the port's own metrics: ``race_adjoint_pads_total{how, kind}``, each
#: padded feed of a backward, read in place by K1 or padded into a canvas
PORT_METRICS = ("race_adjoint_pads_total",)

_TRUTHY = ("1", "true", "yes", "on")


def _env_enabled() -> bool:
    return os.environ.get(ENV_OBS, "").strip().lower() in _TRUTHY


def _env_ring() -> int:
    raw = os.environ.get(ENV_RING, "").strip()
    if not raw:
        return DEFAULT_RING
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError(f"{ENV_RING}={raw!r} is not an integer") from None


def _env_span_ring() -> int:
    raw = os.environ.get(ENV_SPANS, "").strip()
    if not raw:
        return DEFAULT_SPAN_RING
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError(f"{ENV_SPANS}={raw!r} is not an integer") from None


class _State:
    """The process-wide observability state (swapped atomically on reset)."""

    __slots__ = ("enabled", "registry", "events", "spans")

    def __init__(self, enabled: bool, registry: Registry, events: EventLog,
                 spans: SpanLog):
        self.enabled = enabled
        self.registry = registry
        self.events = events
        self.spans = spans


_lock = threading.Lock()
_state = _State(_env_enabled(), Registry(),
                EventLog(_env_ring(),
                         os.environ.get(ENV_EVENTS, "").strip() or None),
                SpanLog(_env_span_ring()))


def enabled() -> bool:
    """Is instrumentation on?  The per-call cost of every disabled site."""
    return _state.enabled


def tracing() -> bool:
    """Does a span record anything: obs on, or ``torch.profiler`` recording
    (whose ranges the spans then open)?  Two flag reads."""
    return _state.enabled or _profiler._is_profiler_enabled


def configure(enabled=None, events_path=..., ring=None) -> None:
    """Programmatic control (overrides the env): flip the flag, point the
    JSONL sink somewhere (``None`` detaches it), resize the ring.  Metric
    and event state is *kept* — use :func:`reset` for a clean slate."""
    global _state
    with _lock:
        st = _state
        new_enabled = st.enabled if enabled is None else bool(enabled)
        ev = st.events
        if events_path is not ... or ring is not None:
            old = ev
            ev = EventLog(ring if ring is not None else old._ring.maxlen,
                          (old.sink_path if events_path is ...
                           else (str(events_path) if events_path else None)))
            for e in old.events():  # carry history across sink swaps
                ev._ring.append(e)
                ev._seq = max(ev._seq, e.get("seq", 0))
            old.close()
        _state = _State(new_enabled, st.registry, ev, st.spans)


def reset() -> None:
    """Fresh registry + event log + span log, enabled flag re-read from the
    env.  Test isolation and long-lived-process rollover both go through
    here."""
    global _state
    with _lock:
        _state.events.close()
        _state = _State(_env_enabled(), Registry(),
                        EventLog(_env_ring(),
                                 os.environ.get(ENV_EVENTS, "").strip()
                                 or None),
                        SpanLog(_env_span_ring()))


# -- instrumentation front doors (cheap when disabled) -----------------------


def span(name: str, **labels):
    """Time a phase: ``with obs.span("detect"): ...``.  Disabled -> the
    profiler's range ``race.<name>`` alone while ``torch.profiler`` records,
    else a shared no-op context manager (no allocation, no clock read).
    Enabled -> a :class:`Span`, which opens the same range while the
    profiler records."""
    st = _state
    if st.enabled:
        return Span(name, st.registry, labels, st.spans,
                    profiler_range(name) if _profiler._is_profiler_enabled
                    else None)
    if _profiler._is_profiler_enabled:
        return profiler_range(name)
    return NOOP_SPAN


def event(kind: str, **fields):
    """Emit one structured decision event (ring + optional JSONL sink).
    Disabled -> returns None without building anything."""
    st = _state
    if not st.enabled:
        return None
    return st.events.emit(kind, **fields)


def counter(name: str, **labels) -> Counter:
    return _state.registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _state.registry.gauge(name, **labels)


def histogram(name: str, edges=DEFAULT_BUCKETS, **labels) -> Histogram:
    return _state.registry.histogram(name, edges, **labels)


def metrics() -> Registry:
    """The live registry (callers should prefer the helpers above)."""
    return _state.registry


def event_log() -> EventLog:
    return _state.events


def events(kind=None) -> list:
    return _state.events.events(kind)


# -- read side ---------------------------------------------------------------


def snapshot(label_filter=None, include_events: bool = False) -> dict:
    """Metrics snapshot (optionally filtered to series carrying every
    ``label_filter`` pair); ``include_events`` adds the event ring."""
    st = _state
    out = st.registry.snapshot(label_filter)
    out["event_counts"] = st.events.counts()
    if include_events:
        out["events"] = st.events.events()
    return out


def span_summary() -> dict:
    """``{span: {"count": n, "total_s": s}}`` — the compact phase breakdown
    benchmark rows are annotated with."""
    return _state.registry.span_summary()


def span_log() -> SpanLog:
    return _state.spans


def span_records() -> list:
    """Completed-span timeline records (newest ``RACE_OBS_SPANS`` kept) —
    the raw material of :mod:`repro_torch.obs.trace` Chrome-trace export."""
    return _state.spans.records()


def render_prometheus() -> str:
    return _state.registry.render_prometheus()


def render_json(label_filter=None) -> str:
    return _state.registry.render_json(label_filter)


def run_stamp() -> dict:
    """Identity stamp for machine-readable artifacts: schema version, UTC
    timestamp, the device (``cuda:<card name>``, or ``cpu:<processor>``
    when no card is present), the torch and CUDA versions, and the host
    signature (CPU count + node name).  The benchmark history store
    (:mod:`repro_torch.obs.history`) keys baselines on (device, torch,
    cuda, host_cpu_count), so numbers from one card or toolkit never gate
    against another's, nor against a row of the JAX package."""
    import datetime
    import platform

    stamp = dict(
        schema=OBS_SCHEMA,
        ts=datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    )
    try:
        import torch

        if torch.cuda.is_available():
            stamp["device"] = f"cuda:{torch.cuda.get_device_name()}"
        else:
            stamp["device"] = (
                f"cpu:{platform.processor() or platform.machine()}")
        stamp["torch"] = torch.__version__
        stamp["cuda"] = torch.version.cuda
    except Exception:  # pragma: no cover - stamping must never fail
        stamp["device"] = "unknown"
        stamp["torch"] = "unknown"
        stamp["cuda"] = "unknown"
    try:
        stamp["host_cpu_count"] = os.cpu_count() or 0
        stamp["host"] = platform.node() or "unknown"
    except Exception:  # pragma: no cover - stamping must never fail
        stamp["host_cpu_count"] = 0
        stamp["host"] = "unknown"
    return stamp


def dump(path=None) -> dict:
    """Full telemetry document: ``{"stamp", "metrics", "events", "spans"}``;
    written as JSON when ``path`` is given.  ``repro_torch.obs.report`` renders
    these (and ``--trace-out`` turns the span records into a Chrome
    trace)."""
    doc = dict(stamp=run_stamp(), metrics=_state.registry.snapshot(),
               events=_state.events.events(),
               event_counts=_state.events.counts(),
               spans=_state.spans.records(),
               span_origin_epoch=epoch_of_origin())
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    return doc
