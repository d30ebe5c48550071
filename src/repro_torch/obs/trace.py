"""Own copy of ``repro/obs/trace.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Chrome-trace export of the span timeline.

Turns the :class:`repro_torch.obs.spans.SpanLog` records — leaf name, nesting
path, wall-clock start offset, duration, thread — into the Trace Event
Format that ``chrome://tracing``, Perfetto (https://ui.perfetto.dev), and
``about:tracing`` all load:

    PYTHONPATH=src python -m repro_torch.obs.report OBS_metrics.json \
        --trace-out trace.json

Each completed span becomes one complete ("ph": "X") event whose ``ts`` /
``dur`` are microseconds on the shared process time axis, so the nested
detect / lower / compile / run phases reconstruct visually as a flame
graph per thread — the event's ``args`` carry the nesting ``path`` and the
span's labels (plan hash, backend) for click-through inspection.  Thread
metadata ("ph": "M") events name the rows.

The exporter is read-side only: it never touches the live registry, so it
can render a dump written by another process (CI artifacts) as easily as
the in-process log.
"""
from __future__ import annotations

import json
from typing import Mapping, Optional, Sequence

#: trace process id — one RACE process per trace document
TRACE_PID = 1


def chrome_trace(spans: Sequence[Mapping],
                 stamp: Optional[Mapping] = None,
                 origin_epoch: Optional[float] = None) -> dict:
    """Build a Trace Event Format document from span timeline records.

    ``spans`` are :meth:`SpanLog.records` dicts (or their JSON round-trip
    from an ``obs.dump`` file); malformed entries are skipped, never fatal.
    ``stamp`` (an ``obs.run_stamp``) and ``origin_epoch`` ride along in
    ``otherData`` so a trace artifact stays self-identifying.
    """
    events = []
    threads: dict = {}
    for rec in spans:
        try:
            ts = float(rec["ts_us"])
            dur = float(rec["dur_us"])
            name = str(rec["name"])
        except (KeyError, TypeError, ValueError):
            continue  # tolerate foreign/corrupt records
        tid = rec.get("tid")
        tid = int(tid) if isinstance(tid, (int, float)) else 0
        threads.setdefault(tid, str(rec.get("thread", f"tid-{tid}")))
        args = {"path": str(rec.get("path", name))}
        labels = rec.get("labels")
        if isinstance(labels, Mapping):
            args.update({str(k): str(v) for k, v in labels.items()})
        events.append(dict(name=name, cat="race", ph="X",
                           ts=ts, dur=dur, pid=TRACE_PID, tid=tid,
                           args=args))
    # stable render: viewers don't require ordering, but diffable artifacts
    # and deterministic tests do
    events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"], e["name"]))
    meta = [dict(name="process_name", ph="M", pid=TRACE_PID, tid=0,
                 args={"name": "repro_torch-race"})]
    for tid in sorted(threads):
        meta.append(dict(name="thread_name", ph="M", pid=TRACE_PID,
                         tid=tid, args={"name": threads[tid]}))
    other = {}
    if stamp:
        other.update({str(k): v for k, v in stamp.items()})
    if origin_epoch is not None:
        other["span_origin_epoch"] = float(origin_epoch)
    doc = dict(traceEvents=meta + events, displayTimeUnit="ms")
    if other:
        doc["otherData"] = other
    return doc


def write_trace(path, spans: Sequence[Mapping],
                stamp: Optional[Mapping] = None,
                origin_epoch: Optional[float] = None) -> dict:
    """Render and write ``chrome_trace`` JSON to ``path``; returns the doc."""
    doc = chrome_trace(spans, stamp=stamp, origin_epoch=origin_epoch)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def export_current(path) -> dict:
    """Write the live process's span log as a Chrome trace (convenience for
    in-process use; the report CLI goes through dump files instead)."""
    from .. import obs

    return write_trace(path, obs.span_records(), stamp=obs.run_stamp(),
                       origin_epoch=obs.epoch_of_origin())
