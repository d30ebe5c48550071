"""Own copy of ``repro/obs/events.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Structured decision events: in-memory ring buffer + append-only JSONL.

Every *decision* the pipeline computes and used to discard becomes one
event: a capability-probe fallback with its structured reasons, an adjoint
refusal, a frontend diagnostic, a tuning gate verdict, an executor-cache
build or eviction.  Events are plain dicts —

    {"seq": 17, "ts": 1754700000.123, "kind": "backend_fallback",
     "plan": "ab12...", "reasons": ["strided-aux: ..."], ...}

— appended to a bounded in-process ring (``RACE_OBS_RING`` entries, default
4096) and, when ``RACE_OBS_EVENTS`` names a file, to an append-only JSONL
sink so decisions survive the process and feed ``repro_torch.obs.report``.

The sink is line-buffered and lock-serialized; a broken sink (unwritable
path, disk full) degrades to ring-only — telemetry must never take the
pipeline down.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_RING = 4096


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    return str(v)


class EventLog:
    """Bounded ring of structured events with an optional JSONL sink."""

    def __init__(self, ring: int = DEFAULT_RING,
                 sink_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._seq = 0
        self.sink_path = sink_path
        self._sink = None
        self.sink_errors = 0

    def emit(self, kind: str, **fields) -> dict:
        ev = {"seq": 0, "ts": time.time(), "kind": str(kind)}
        for k, v in fields.items():
            ev[str(k)] = _jsonable(v)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            if self.sink_path is not None:
                try:
                    if self._sink is None:
                        self._sink = open(self.sink_path, "a", buffering=1)
                    self._sink.write(
                        json.dumps(ev, separators=(",", ":")) + "\n")
                except OSError:
                    # unwritable sink: degrade to ring-only, keep serving
                    self.sink_errors += 1
                    self._sink = None
                    self.sink_path = None
        return ev

    def events(self, kind: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def counts(self) -> dict:
        """``{kind: n}`` over the ring (reporting convenience)."""
        out: dict = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def __len__(self) -> int:
        return len(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:  # pragma: no cover - close-time race
                    pass
                self._sink = None


def load_jsonl(path) -> list:
    """Read an events JSONL file tolerantly (corrupt lines skipped)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict) and "kind" in ev:
                    out.append(ev)
    except OSError:
        pass
    return out
