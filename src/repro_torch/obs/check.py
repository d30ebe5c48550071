"""Own copy of ``repro/obs/check.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Perf-regression sentinel: gate current benchmarks against the history.

    PYTHONPATH=src python -m repro_torch.obs.check BENCH_serving.json ... \
        [--history PATH] [--threshold 0.5] [--min-samples 3] \
        [--gate serving,speedup] [--out BENCH_verdicts.json]

For every row of every given ``BENCH_*.json`` the sentinel looks up the
recorded trajectory of the *same* (section, case) in the *same* environment
(device kind, torch and CUDA versions, host CPU count —
:func:`repro_torch.obs.history.env_key`) and compares each directional
metric against the **median** of the baseline samples.  Every benchmark
number is itself a median of repeats, so the comparison is
median-of-medians — a 1-core CI container's scheduling noise has to be
persistent *and* large to trip it, and two guards make flapping
structurally hard:

  * ``--min-samples`` (default 3): fewer recorded baseline runs than this
    yields an ``insufficient-samples`` verdict that never gates — a fresh
    history window is warn-only by construction, no separate mode flag;
  * ``--threshold`` (default 0.5): the relative slowdown that counts, i.e.
    current must exceed baseline-median by >50% (or undershoot it for
    higher-is-better metrics like ``speedup_RACE``) to be a regression.

Verdicts are structured per (section, case, metric) and always written to
``BENCH_verdicts.json``; the exit code is nonzero only for *confirmed*
regressions in ``--gate``-listed sections (bare ``--gate`` gates every
checked section).  No history configured, no baseline yet, unknown metric
direction — all explicit verdict statuses, never silent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Mapping, Optional, Sequence

from .history import (BenchHistory, case_key, default_history, env_key,
                      row_metrics, rows_of)

#: verdict statuses (fixed vocabulary, pinned by tests)
S_OK = "ok"
S_REGRESSION = "regression"
S_IMPROVED = "improved"
S_NO_BASELINE = "no-baseline"
S_INSUFFICIENT = "insufficient-samples"
S_NO_HISTORY = "no-history"

DEFAULT_THRESHOLD = 0.5
DEFAULT_MIN_SAMPLES = 3

#: metrics where *larger* is better — checked before the lower-better
#: suffix heuristics (``decode_tok_s`` must not match the ``_s`` rule)
_HIGHER_EXACT = ("hit_rate", "scaling_vs_1", "single_over_sharded",
                 "batch_ips")
_HIGHER_SUBSTR = ("speedup",)
_HIGHER_SUFFIX = ("_ips", "_tok_s")

#: metrics where *smaller* is better
_LOWER_EXACT = ("us_per_call", "cold_ms", "retraces")
_LOWER_SUFFIX = ("_us", "_ms", "_ns", "_us_per_item", "_per_call")
_LOWER_PREFIX = ("t_",)
_LOWER_TIME_SUFFIX = ("_s",)  # prefill_s, decode_s, search_s ...


def metric_direction(name: str) -> Optional[str]:
    """``"lower"`` / ``"higher"`` (better), or None for metrics with no
    defined perf direction (counts, fractions, configuration echoes) —
    those get no verdict rather than a made-up one."""
    if (name in _HIGHER_EXACT
            or any(s in name for s in _HIGHER_SUBSTR)
            or name.endswith(_HIGHER_SUFFIX)):
        return "higher"
    if (name in _LOWER_EXACT or name.endswith(_LOWER_SUFFIX)
            or name.startswith(_LOWER_PREFIX)
            or name.endswith(_LOWER_TIME_SUFFIX)):
        return "lower"
    return None


def _judge(current: float, samples: Sequence[float], direction: str,
           threshold: float) -> dict:
    """Compare one metric value against its baseline samples."""
    med = float(statistics.median(samples))
    out = dict(baseline_median=med, baseline_n=len(samples))
    if med <= 0 or current <= 0:
        out.update(status=S_OK, ratio=None)  # degenerate: nothing to ratio
        return out
    # ratio > 1 always means "worse", whatever the metric's direction
    ratio = (current / med) if direction == "lower" else (med / current)
    out["ratio"] = ratio
    if ratio > 1.0 + threshold:
        out["status"] = S_REGRESSION
    elif ratio < 1.0 / (1.0 + threshold):
        out["status"] = S_IMPROVED
    else:
        out["status"] = S_OK
    return out


def evaluate(docs: Sequence[Mapping], history: Optional[BenchHistory],
             threshold: float = DEFAULT_THRESHOLD,
             min_samples: int = DEFAULT_MIN_SAMPLES,
             metrics: Optional[Sequence[str]] = None) -> list:
    """Structured verdicts — one per (section, case, directional metric) —
    for the given ``BENCH_*.json`` documents against ``history``."""
    verdicts = []
    want = set(metrics) if metrics else None
    for doc in docs:
        stamp = doc.get("stamp") or {}
        env = env_key(stamp)
        section = str(doc.get("section", "?"))
        for row in rows_of(doc):
            ck = case_key(row)
            base = (history.baseline(section, ck, env,
                                     exclude_ts=stamp.get("ts"))
                    if history is not None else [])
            for mname, current in sorted(row_metrics(row).items()):
                direction = metric_direction(mname)
                if direction is None or (want and mname not in want):
                    continue
                v = dict(section=section, case=ck, metric=mname,
                         env=env, direction=direction, current=current,
                         threshold=threshold)
                samples = [r["metrics"][mname] for r in base
                           if isinstance(r["metrics"].get(mname),
                                         (int, float))]
                if history is None:
                    v.update(status=S_NO_HISTORY, baseline_n=0)
                elif not samples:
                    v.update(status=S_NO_BASELINE, baseline_n=0)
                elif len(samples) < min_samples:
                    v.update(status=S_INSUFFICIENT,
                             baseline_n=len(samples),
                             baseline_median=float(
                                 statistics.median(samples)))
                else:
                    v.update(_judge(current, samples, direction, threshold))
                verdicts.append(v)
    return verdicts


def summarize(verdicts: Sequence[Mapping]) -> dict:
    out: dict = {}
    for v in verdicts:
        out[v["status"]] = out.get(v["status"], 0) + 1
    return out


def gated_regressions(verdicts: Sequence[Mapping],
                      gate_sections: Optional[Sequence[str]]) -> list:
    """The regressions that fail the run: all of them when gating every
    section (``gate_sections`` empty), else only the listed sections'."""
    gate = set(gate_sections or [])
    return [v for v in verdicts if v["status"] == S_REGRESSION
            and (not gate or v["section"] in gate)]


def _fmt_verdict(v: Mapping) -> str:
    ratio = v.get("ratio")
    base = v.get("baseline_median")
    detail = []
    if base is not None:
        detail.append(f"baseline_median={base:g} (n={v.get('baseline_n')})")
    if ratio is not None:
        detail.append(f"ratio={ratio:.2f}x")
    return (f"[{v['status']:>20}] {v['section']} :: {v['case']} :: "
            f"{v['metric']} = {v['current']:g}"
            + (f"  ({'; '.join(detail)})" if detail else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="compare BENCH_*.json runs against the benchmark "
                    "history and gate on confirmed regressions")
    ap.add_argument("bench", nargs="+",
                    help="BENCH_<section>.json files of the current run")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="history JSONL (default: $RACE_BENCH_HISTORY)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative slowdown that counts as a regression "
                         f"(default {DEFAULT_THRESHOLD})")
    ap.add_argument("--min-samples", type=int, default=DEFAULT_MIN_SAMPLES,
                    help="baseline runs required before a verdict can gate "
                         f"(default {DEFAULT_MIN_SAMPLES})")
    ap.add_argument("--metrics", default="",
                    help="comma list restricting which metrics are judged "
                         "(default: every metric with a known direction)")
    ap.add_argument("--gate", nargs="?", const="", default=None,
                    metavar="SECTIONS",
                    help="exit 1 on confirmed regressions; optional comma "
                         "list limits gating to those sections (verdicts "
                         "for the rest stay informational)")
    ap.add_argument("--out", default="BENCH_verdicts.json", metavar="PATH",
                    help="structured verdict artifact (default "
                         "BENCH_verdicts.json)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    docs = []
    for path in args.bench:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"check: cannot read {path}: {e}", file=sys.stderr)
            return 2
        if not isinstance(doc, dict) or "rows" not in doc:
            print(f"check: {path}: not a BENCH_*.json document",
                  file=sys.stderr)
            return 2
        docs.append(doc)

    # no --history and no $RACE_BENCH_HISTORY -> None: every verdict is an
    # explicit "no-history", and gating can never fire
    history = (BenchHistory(args.history) if args.history
               else default_history())

    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    verdicts = evaluate(docs, history, threshold=args.threshold,
                        min_samples=args.min_samples,
                        metrics=metrics or None)
    gate_sections = ([s.strip() for s in args.gate.split(",") if s.strip()]
                     if args.gate is not None else None)
    failing = (gated_regressions(verdicts, gate_sections)
               if args.gate is not None else [])
    summary = summarize(verdicts)
    artifact = dict(
        history=str(history.path) if history is not None else None,
        threshold=args.threshold, min_samples=args.min_samples,
        gate_sections=gate_sections, summary=summary,
        gated_regressions=len(failing), verdicts=verdicts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)

    if args.format == "json":
        print(json.dumps(artifact, indent=1))
    else:
        for v in verdicts:
            print(_fmt_verdict(v))
        parts = ", ".join(f"{k}={v}" for k, v in sorted(summary.items()))
        print(f"check: {len(verdicts)} verdicts ({parts or 'none'})"
              + (f"; wrote {args.out}" if args.out else ""))
    if failing:
        for v in failing:
            print(f"REGRESSION: {v['section']} :: {v['case']} :: "
                  f"{v['metric']} {v['current']:g} vs median "
                  f"{v['baseline_median']:g} "
                  f"(x{v['ratio']:.2f}, n={v['baseline_n']})",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
