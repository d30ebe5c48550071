"""Own copy of ``repro/obs/metrics.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Process-wide metrics registry: counters, gauges, log-bucket histograms.

The registry is the numeric half of the observability layer (the event log
is the narrative half): every pipeline stage that *counts* something — runs
per plan hash, cache hits, fallback selections — or *times* something —
detect/lower/compile/run phases — lands here.  Three metric kinds, the
smallest set that covers the pipeline:

  * :class:`Counter`   — monotone ``inc``; rates derive from snapshots;
  * :class:`Gauge`     — last-write-wins ``set`` (e.g. a plan's reduced-ops
    fraction, the executor cache's current size);
  * :class:`Histogram` — fixed *log-scale* buckets (quarter-decade edges
    spanning 1µs .. 100s by default), so one bucket layout serves both a
    2µs cache hit and a 30s cold compile without per-series configuration.

Everything is thread-safe: one lock per registry guards series creation,
one lock per series guards updates (updates on the serving hot path never
contend with creation).  ``snapshot()`` returns plain dicts; exposition is
Prometheus text format (:meth:`Registry.render_prometheus`) or JSON
(:meth:`Registry.render_json`) — both derived from the same snapshot, no
second source of truth.

Zero dependencies: stdlib only, importable from any layer without cycles.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from typing import Mapping, Optional, Sequence, Tuple

#: default histogram bucket upper bounds: quarter-decade log scale over
#: 1µs .. 100s (in seconds) — 33 buckets plus the implicit +Inf overflow.
#: Fixed edges keep every series mergeable and the exposition cumulative.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (k / 4.0), 12) for k in range(-24, 9))


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with cumulative counts (thread-safe).

    ``edges`` are the bucket *upper bounds* in ascending order; one overflow
    bucket (+Inf) is implicit.  ``observe`` is O(log buckets) via bisect.
    """

    __slots__ = ("_lock", "edges", "_counts", "count", "sum", "min", "max")

    def __init__(self, edges: Sequence[float] = DEFAULT_BUCKETS):
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self._lock = threading.Lock()
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)  # [..., +Inf overflow]
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def bucket_counts(self) -> list:
        """Per-bucket (non-cumulative) counts; last entry is the overflow."""
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate (upper edge of the bucket the
        q-th observation falls in), or None when empty."""
        with self._lock:
            if not self.count:
                return None
            target = q * self.count
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= target and c:
                    return (self.edges[i] if i < len(self.edges)
                            else self.max)
            return self.max

    def snapshot(self) -> dict:
        with self._lock:
            return dict(count=self.count, sum=self.sum,
                        min=(None if self.count == 0 else self.min),
                        max=(None if self.count == 0 else self.max),
                        edges=list(self.edges), counts=list(self._counts))


class Registry:
    """Get-or-create registry of labeled metric series.

    Series identity is ``(name, sorted label items)``; asking twice returns
    the same object, so call sites never hold references across config
    resets (they re-ask, which is one dict lookup)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def _get(self, table: dict, name: str, labels: Mapping,
             factory) -> object:
        key = (name, _label_key(labels))
        m = table.get(key)
        if m is None:
            with self._lock:
                m = table.get(key)
                if m is None:
                    m = table[key] = factory()
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge)

    def histogram(self, name: str, edges: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(self._histograms, name, labels,
                         lambda: Histogram(edges))

    # -- read side -----------------------------------------------------------

    def _items(self, table: dict) -> list:
        with self._lock:
            return list(table.items())

    def snapshot(self, label_filter: Optional[Mapping] = None) -> dict:
        """Plain-dict view of every series: ``{"counters": {series: value},
        "gauges": {...}, "histograms": {series: {count, sum, ...}}}``.

        ``label_filter`` keeps only series whose labels include every given
        ``key=value`` pair (e.g. ``{"plan": "ab12..."}`` for one plan's
        telemetry)."""
        want = _label_key(label_filter) if label_filter else ()

        def keep(labels: tuple) -> bool:
            return all(kv in labels for kv in want)

        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in self._items(self._counters):
            if keep(labels):
                out["counters"][_series_name(name, labels)] = m.value
        for (name, labels), m in self._items(self._gauges):
            if keep(labels):
                out["gauges"][_series_name(name, labels)] = m.value
        for (name, labels), m in self._items(self._histograms):
            if keep(labels):
                out["histograms"][_series_name(name, labels)] = m.snapshot()
        return out

    def span_summary(self) -> dict:
        """Aggregate of the ``race_span_seconds`` histograms by leaf span
        name: ``{span: {"count": n, "total_s": s}}`` — the compact breakdown
        benchmarks annotate their rows with."""
        agg: dict = {}
        for (name, labels), m in self._items(self._histograms):
            if name != "race_span_seconds":
                continue
            span = dict(labels).get("span", "?")
            snap = agg.setdefault(span, dict(count=0, total_s=0.0))
            snap["count"] += m.count
            snap["total_s"] += m.sum
        return agg

    # -- exposition ----------------------------------------------------------

    def render_json(self, label_filter: Optional[Mapping] = None) -> str:
        return json.dumps(self.snapshot(label_filter), indent=1,
                          sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, cumulative-bucket
        histograms with ``_bucket``/``_sum``/``_count`` series).

        Label values are escaped per the exposition format (backslash,
        double quote, newline) — plan hashes, file paths, and diagnostic
        strings all flow into labels, so unescaped values would silently
        corrupt the scrape."""
        lines = []

        def esc(v) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_labels(labels: tuple, extra: tuple = ()) -> str:
            items = labels + extra
            if not items:
                return ""
            return ("{" + ",".join(
                f'{k}="{esc(v)}"' for k, v in items) + "}")

        by_name: dict = {}
        for (name, labels), m in self._items(self._counters):
            by_name.setdefault((name, "counter"), []).append((labels, m))
        for (name, labels), m in self._items(self._gauges):
            by_name.setdefault((name, "gauge"), []).append((labels, m))
        for (name, kind) in sorted(by_name):
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in sorted(by_name[(name, kind)]):
                lines.append(f"{name}{fmt_labels(labels)} {m.value:g}")
        hists: dict = {}
        for (name, labels), m in self._items(self._histograms):
            hists.setdefault(name, []).append((labels, m))
        for name in sorted(hists):
            lines.append(f"# TYPE {name} histogram")
            for labels, m in sorted(hists[name]):
                snap = m.snapshot()
                acc = 0
                for edge, c in zip(snap["edges"], snap["counts"]):
                    acc += c
                    lines.append(
                        f"{name}_bucket"
                        f"{fmt_labels(labels, (('le', f'{edge:g}'),))} "
                        f"{acc}")
                acc += snap["counts"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{fmt_labels(labels, (('le', '+Inf'),))} {acc}")
                lines.append(
                    f"{name}_sum{fmt_labels(labels)} {snap['sum']:g}")
                lines.append(
                    f"{name}_count{fmt_labels(labels)} {snap['count']}")
        return "\n".join(lines) + ("\n" if lines else "")
