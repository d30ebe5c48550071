"""Own copy of ``repro/obs/report.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Render a telemetry summary from an ``obs.dump`` JSON or an events JSONL.

    PYTHONPATH=src python -m repro_torch.obs.report OBS_metrics.json
    PYTHONPATH=src python -m repro_torch.obs.report --events obs-events.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report OBS_metrics.json \
        --require-spans detect,lower,compile,run   # CI wiring guard
    PYTHONPATH=src python -m repro_torch.obs.report OBS_metrics.json \
        --trace-out trace.json    # chrome://tracing / Perfetto timeline

Sections: span breakdown (count / total / mean / p50 / p95 / p99 from the
log-bucket histograms), top counters, gauges, and event counts grouped by
``kind`` (with per-reason / per-code sub-counts for decision kinds).

``--require-spans`` exits 2 when any named span histogram is missing or has
zero observations — the CI regression guard that catches instrumentation
being silently unwired; the failure message includes the spans that *were*
recorded with their timing summaries, so the report names what actually ran.

``--require-events kind[:min],...`` is the same guard for *events* (dump
events plus ``--events`` JSONL): exit 2 when a kind was recorded fewer than
``min`` times (default 1).  E.g. ``--require-events compile_cache_hit`` is
the CI assertion that the persistent compilation cache actually served the
second run.

``--trace-out`` converts the dump's span timeline records into a Chrome
Trace Event Format file (see :mod:`repro_torch.obs.trace`).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter as _Counter

from .events import load_jsonl

#: event fields worth sub-grouping in the summary (decision vocabularies)
_GROUP_FIELDS = ("reason", "code", "status", "backend", "requested")


def _load_dump(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a telemetry dump")
    return doc


def _hist_stats(snap: dict) -> dict:
    count, total = snap.get("count", 0), snap.get("sum", 0.0)
    edges, counts = snap.get("edges", []), snap.get("counts", [])

    def q(frac):
        if not count:
            return None
        target = frac * count
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target and c:
                return edges[i] if i < len(edges) else snap.get("max")
        return snap.get("max")

    return dict(count=count, total=total,
                mean=(total / count if count else None),
                p50=q(0.5), p95=q(0.95), p99=q(0.99))


def span_table(metrics: dict) -> dict:
    """Aggregate ``race_span_seconds`` histograms by leaf span name."""
    spans: dict = {}
    for series, snap in (metrics.get("histograms") or {}).items():
        if not series.startswith("race_span_seconds"):
            continue
        labels = {}
        if "{" in series:
            inner = series[series.index("{") + 1:series.rindex("}")]
            labels = dict(kv.split("=", 1) for kv in inner.split(",")
                          if "=" in kv)
        name = labels.get("span", "?")
        agg = spans.setdefault(name, dict(count=0, sum=0.0, merged=[]))
        agg["count"] += snap.get("count", 0)
        agg["sum"] += snap.get("sum", 0.0)
        agg["merged"].append(snap)
    out = {}
    for name, agg in spans.items():
        # merge bucket counts across label sets (shared fixed edges)
        edges = agg["merged"][0].get("edges", [])
        counts = [0] * (len(edges) + 1)
        mx = None
        for snap in agg["merged"]:
            for i, c in enumerate(snap.get("counts", [])):
                if i < len(counts):
                    counts[i] += c
            m = snap.get("max")
            mx = m if mx is None else max(mx, m if m is not None else mx)
        out[name] = _hist_stats(dict(count=agg["count"], sum=agg["sum"],
                                     edges=edges, counts=counts, max=mx))
    return out


def event_summary(events: list) -> dict:
    """``{kind: {"count": n, "by": {field: {value: n}}}}``."""
    out: dict = {}
    for ev in events:
        kind = ev.get("kind", "?")
        rec = out.setdefault(kind, {"count": 0, "by": {}})
        rec["count"] += 1
        for f in _GROUP_FIELDS:
            v = ev.get(f)
            if isinstance(v, str):
                rec["by"].setdefault(f, _Counter())[v] += 1
    for rec in out.values():
        rec["by"] = {f: dict(c) for f, c in rec["by"].items()}
    return out


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def render_text(doc: dict, top: int = 20) -> str:
    lines = []
    stamp = doc.get("stamp") or {}
    if stamp:
        lines.append(
            f"# telemetry  schema={stamp.get('schema')} ts={stamp.get('ts')}"
            f" device={stamp.get('device')} torch={stamp.get('torch')}"
            f" cuda={stamp.get('cuda')}")
    metrics = doc.get("metrics") or {}
    spans = span_table(metrics)
    if spans:
        lines.append("")
        lines.append(f"{'span':<16}{'count':>8}{'total':>12}{'mean':>12}"
                     f"{'p50':>12}{'p95':>12}{'p99':>12}")
        for name in sorted(spans, key=lambda n: -spans[n]["total"]):
            s = spans[name]
            lines.append(
                f"{name:<16}{s['count']:>8}{_fmt_s(s['total']):>12}"
                f"{_fmt_s(s['mean']):>12}{_fmt_s(s['p50']):>12}"
                f"{_fmt_s(s.get('p95')):>12}{_fmt_s(s['p99']):>12}")
    counters = metrics.get("counters") or {}
    if counters:
        lines.append("")
        lines.append("counters (top by value):")
        for series in sorted(counters, key=lambda s: -counters[s])[:top]:
            lines.append(f"  {series} = {counters[series]:g}")
    gauges = metrics.get("gauges") or {}
    if gauges:
        lines.append("")
        lines.append("gauges:")
        for series in sorted(gauges)[:top]:
            lines.append(f"  {series} = {gauges[series]:g}")
    evs = event_summary(doc.get("events") or [])
    if evs:
        lines.append("")
        lines.append("events:")
        for kind in sorted(evs, key=lambda k: -evs[k]["count"]):
            lines.append(f"  {kind} x{evs[kind]['count']}")
            for f, vals in sorted(evs[kind]["by"].items()):
                for v, n in sorted(vals.items(), key=lambda kv: -kv[1]):
                    lines.append(f"    {f}={v} x{n}")
    return "\n".join(lines) + "\n"


def check_spans(doc: dict, required: list) -> list:
    """Names from ``required`` whose span histogram is missing or empty."""
    spans = span_table(doc.get("metrics") or {})
    return [name for name in required
            if spans.get(name, {}).get("count", 0) <= 0]


def parse_event_requirements(spec: str) -> list:
    """``"kind[:min],..."`` -> ``[(kind, min_count), ...]``; bad minimums
    raise ValueError so CI misconfigurations fail loudly."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, mn = part.partition(":")
        if mn and (not mn.isdigit() or int(mn) < 1):
            raise ValueError(
                f"--require-events: bad minimum {mn!r} for {kind!r}")
        out.append((kind.strip(), int(mn) if mn else 1))
    return out


def check_events(doc: dict, required: list) -> list:
    """``(kind, want, got)`` for each requirement the events fail to meet."""
    counts = _Counter(ev.get("kind", "?") for ev in doc.get("events") or [])
    return [(kind, want, counts.get(kind, 0))
            for kind, want in required if counts.get(kind, 0) < want]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render a RACE telemetry summary")
    ap.add_argument("dump", nargs="?", default=None,
                    help="obs.dump JSON file (metrics + events)")
    ap.add_argument("--events", default=None,
                    help="events JSONL file (RACE_OBS_EVENTS sink)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--require-spans", default="",
                    help="comma-separated span names that must have >0 "
                         "observations; exit 2 otherwise (CI wiring guard)")
    ap.add_argument("--require-events", default="", metavar="KIND[:MIN],...",
                    help="comma-separated event kinds (optionally "
                         "kind:min_count, default 1) that must appear in "
                         "the dump events + --events JSONL; exit 2 "
                         "otherwise")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the dump's span timeline records as a "
                         "Chrome Trace Event Format JSON (chrome://tracing "
                         "/ Perfetto); exit 2 when the dump has no span "
                         "records")
    args = ap.parse_args(argv)

    if args.dump is None and args.events is None:
        ap.error("need a dump file and/or --events")
    doc = _load_dump(args.dump) if args.dump else {"metrics": {},
                                                   "events": []}
    if args.events:
        doc["events"] = (doc.get("events") or []) + load_jsonl(args.events)

    if args.format == "json":
        out = dict(stamp=doc.get("stamp"),
                   spans=span_table(doc.get("metrics") or {}),
                   counters=(doc.get("metrics") or {}).get("counters", {}),
                   gauges=(doc.get("metrics") or {}).get("gauges", {}),
                   events=event_summary(doc.get("events") or []))
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        sys.stdout.write(render_text(doc))

    if args.trace_out:
        from .trace import write_trace

        recs = doc.get("spans") or []
        if not recs:
            print("NO SPAN RECORDS: the dump carries no span timeline "
                  "(RACE_OBS off, pre-span-log artifact, or nothing ran) — "
                  "cannot write a trace", file=sys.stderr)
            return 2
        write_trace(args.trace_out, recs, stamp=doc.get("stamp"),
                    origin_epoch=doc.get("span_origin_epoch"))
        print(f"trace: wrote {args.trace_out} ({len(recs)} spans)")

    required = [s for s in args.require_spans.split(",") if s.strip()]
    if required:
        missing = check_spans(doc, [s.strip() for s in required])
        if missing:
            print(f"MISSING SPANS: {','.join(missing)} — instrumentation "
                  f"unwired or the run executed nothing", file=sys.stderr)
            # timing context: what *did* run, with its latency summary, so
            # the failure message localizes the unwired phase
            spans = span_table(doc.get("metrics") or {})
            if spans:
                print("recorded spans (count/total/p50/p95):",
                      file=sys.stderr)
                for name in sorted(spans, key=lambda n: -spans[n]["total"]):
                    s = spans[name]
                    print(f"  {name}: {s['count']}x total="
                          f"{_fmt_s(s['total'])} p50={_fmt_s(s['p50'])} "
                          f"p95={_fmt_s(s.get('p95'))}", file=sys.stderr)
            else:
                print("recorded spans: none", file=sys.stderr)
            return 2
        print(f"require-spans ok: {','.join(s.strip() for s in required)}")

    if args.require_events:
        try:
            wanted = parse_event_requirements(args.require_events)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        failed = check_events(doc, wanted)
        if failed:
            for kind, want, got in failed:
                print(f"MISSING EVENTS: {kind} x{got} (need >= {want}) — "
                      f"the instrumented path did not run or its events "
                      f"were not captured", file=sys.stderr)
            evs = event_summary(doc.get("events") or [])
            if evs:
                print("recorded event kinds:", file=sys.stderr)
                for kind in sorted(evs, key=lambda k: -evs[k]["count"]):
                    print(f"  {kind} x{evs[kind]['count']}",
                          file=sys.stderr)
            else:
                print("recorded event kinds: none", file=sys.stderr)
            return 2
        print("require-events ok: " + ",".join(
            f"{k}:{m}" for k, m in wanted))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
