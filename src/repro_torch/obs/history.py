"""Own copy of ``repro/obs/history.py`` for the PyTorch port, which imports
nothing of ``repro``; ``tests/test_torch_obs.py`` and
``tests/test_torch_sentinel.py`` hold the two against drift.

Cross-run benchmark history: an append-only JSONL perf trajectory.

Every ``benchmarks/*.py --json`` section appends its structured rows here
(one record per row), so the ``BENCH_*.json`` snapshots stop being
dead-ends: the regression sentinel (:mod:`repro_torch.obs.check`) compares each
new run against the recorded baseline *for the same environment* and gates
merges on confirmed slowdowns.

One JSON-lines file — ``$RACE_BENCH_HISTORY`` (a directory, or a
``*.jsonl`` file path); unset means history is off (benchmarks skip the
append, the sentinel reports ``no-history``).  Records look like::

    {"schema": 1, "ts": "2026-08-09T12:00:00+00:00", "run": "…/412",
     "env": "cuda:<card>|torch=<version>|cuda=<version>|cores=8",
     "sha": "ce0982f", "section": "serving",
     "case": "backend=hopper;case=gaussian",
     "metrics": {"us_per_call": 182.3, "cold_ms": 410.2, ...}}

keyed by the :func:`repro_torch.obs.run_stamp` provenance — device kind,
torch and CUDA versions, host CPU count — plus the git SHA of the measured
tree, so a 1-core CI container's numbers never become a workstation's
baseline.

Durability mirrors the reference's tuning store (same contract, pinned by
tests): writes are atomic renames serialized by an advisory ``flock`` on a
sidecar lock file; loading tolerates corrupt/truncated lines and unreadable
files (degrade to "no history", never raise); records of *other* schema
versions are preserved verbatim through rewrites; and the file stays
bounded — :meth:`BenchHistory.compact` keeps the newest
``$RACE_BENCH_HISTORY_KEEP`` records per (env, section, case) series,
invoked automatically when a load sees the file exceed the line threshold.
Unlike the tuning store the history is *append-only with retention*, not
last-write-wins: a series' whole recent trajectory is the point.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterable, Mapping, Optional

HISTORY_SCHEMA = 1

ENV_HISTORY = "RACE_BENCH_HISTORY"
#: per-(env, section, case) retention applied by :meth:`BenchHistory.compact`
ENV_HISTORY_KEEP = "RACE_BENCH_HISTORY_KEEP"
DEFAULT_KEEP = 128

#: auto-compaction threshold (physical lines), mirroring the tuning store
COMPACT_LINE_THRESHOLD = 4096

#: row fields that *identify* a benchmark case (joined into the series key)
#: rather than measure it — everything numeric outside this set is a metric
IDENTITY_FIELDS = ("name", "case", "backend", "n", "shards", "strategy",
                   "tag", "variant", "level", "arch", "compile_cache",
                   "batch", "concurrency")

try:  # POSIX advisory locking; harmlessly absent elsewhere
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None


def history_file() -> Optional[Path]:
    """Resolve ``$RACE_BENCH_HISTORY`` (file or dir); None when unset."""
    raw = os.environ.get(ENV_HISTORY, "").strip()
    if not raw:
        return None
    p = Path(raw).expanduser()
    return p if p.suffix == ".jsonl" else p / "bench-history.jsonl"


def keep_limit() -> int:
    raw = os.environ.get(ENV_HISTORY_KEEP, "").strip()
    if not raw:
        return DEFAULT_KEEP
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_HISTORY_KEEP}={raw!r} is not an integer") from None
    if v <= 0:
        raise ValueError(f"{ENV_HISTORY_KEEP} must be > 0, got {raw}")
    return v


def env_key(stamp: Mapping) -> str:
    """The baseline-comparability key of a run: device kind, torch and CUDA
    versions, host CPU count.  Hostname is deliberately excluded — ephemeral
    CI runners are interchangeable, their random node names are not.  The
    reference keys on ``device|jax=…|cores=…``, so a row of the port never
    shares a baseline with a row of the JAX package, even in one file."""
    return (f"{stamp.get('device', 'unknown')}"
            f"|torch={stamp.get('torch', 'unknown')}"
            f"|cuda={stamp.get('cuda', 'unknown')}"
            f"|cores={stamp.get('host_cpu_count', 0)}")


def git_sha() -> str:
    """Best-effort commit identity: ``$GITHUB_SHA`` (CI), else the work
    tree's HEAD, else ``"unknown"`` — provenance only, never a key."""
    sha = os.environ.get("GITHUB_SHA", "").strip()
    if sha:
        return sha[:12]
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def case_key(row: Mapping) -> str:
    """Stable identity of one benchmark row within its section: the sorted
    ``field=value`` pairs of whichever :data:`IDENTITY_FIELDS` it carries."""
    parts = []
    for f in sorted(IDENTITY_FIELDS):
        v = row.get(f)
        if v is None or isinstance(v, (dict, list)):
            continue
        parts.append(f"{f}={v}")
    return ";".join(parts) if parts else "?"


def row_metrics(row: Mapping) -> dict:
    """The measurable half of a row: finite numeric scalars that are not
    identity fields (bools excluded; nested structures skipped)."""
    out = {}
    for k, v in row.items():
        if k in IDENTITY_FIELDS or isinstance(v, bool):
            continue
        if isinstance(v, (int, float)) and v == v:  # NaN-free
            out[str(k)] = float(v)
    return out


def rows_of(doc: Mapping) -> list:
    """Flatten a ``BENCH_*.json`` document's rows (the speedup section nests
    its per-case rows under ``rows["cases"]``)."""
    rows = doc.get("rows")
    if isinstance(rows, Mapping):
        rows = rows.get("cases", [])
    return [r for r in (rows or []) if isinstance(r, Mapping)]


def make_records(section: str, rows: Iterable[Mapping], stamp: Mapping,
                 sha: Optional[str] = None) -> list:
    """One history record per row that has at least one numeric metric."""
    sha = sha if sha is not None else git_sha()
    env = env_key(stamp)
    ts = str(stamp.get("ts", ""))
    run = f"{ts}/{os.getpid()}"
    recs = []
    for row in rows:
        metrics = row_metrics(row)
        if not metrics:
            continue
        recs.append(dict(schema=HISTORY_SCHEMA, ts=ts, run=run, env=env,
                         sha=sha, section=str(section),
                         case=case_key(row), metrics=metrics))
    return recs


class BenchHistory:
    """Mtime-checked view over one append-only JSON-lines history file."""

    def __init__(self, path, compact_threshold: int = COMPACT_LINE_THRESHOLD):
        self.path = Path(path)
        self.compact_threshold = compact_threshold
        self._records: list = []
        self._foreign: list = []  # other-schema lines, verbatim
        self._raw_lines = 0
        self._stamp = object()  # never equals a real stat, forces first load
        self._lock = threading.Lock()
        self._compacting = False

    # -- loading ------------------------------------------------------------

    def _stat(self):
        try:
            st = os.stat(self.path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _load(self, stamp) -> None:
        records: list = []
        foreign: list = []
        try:
            text = self.path.read_bytes().decode("utf-8", errors="replace")
        except OSError:
            text = ""
        n_lines = 0
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            n_lines += 1
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # corrupt / truncated line: skip, never crash
            if (not isinstance(rec, dict)
                    or rec.get("schema") != HISTORY_SCHEMA
                    or not isinstance(rec.get("metrics"), dict)):
                # other-schema lines survive rewrites verbatim (a newer or
                # older library sharing the file owns them); truly
                # malformed lines stay dropped
                if isinstance(rec, dict) and "schema" in rec:
                    foreign.append(line)
                continue
            records.append(rec)
        self._records = records
        self._foreign = foreign
        self._raw_lines = n_lines
        self._stamp = stamp

    def _maybe_reload(self) -> None:
        stamp = self._stat()
        if stamp != self._stamp:
            with self._lock:
                if stamp != self._stamp:
                    self._load(stamp)
            self._maybe_autocompact()

    def _maybe_autocompact(self) -> None:
        if self._compacting or self._raw_lines <= self.compact_threshold:
            return
        try:
            self.compact()
        except Exception:  # pragma: no cover - e.g. read-only history dir
            pass

    # -- read ---------------------------------------------------------------

    def records(self) -> list:
        self._maybe_reload()
        return list(self._records)

    def __len__(self) -> int:
        self._maybe_reload()
        return len(self._records)

    def baseline(self, section: str, case: str, env: str,
                 exclude_ts: Optional[str] = None) -> list:
        """The series for one (section, case) in one environment, oldest
        first; ``exclude_ts`` drops the current run's own records so a
        just-appended row never baselines itself."""
        self._maybe_reload()
        out = [r for r in self._records
               if r.get("section") == section and r.get("case") == case
               and r.get("env") == env
               and (exclude_ts is None or r.get("ts") != exclude_ts)]
        out.sort(key=lambda r: str(r.get("ts", "")))
        return out

    # -- write --------------------------------------------------------------

    def _rewrite_locked(self, mutate) -> None:
        """Read-mutate-replace under the advisory file lock (the same
        durability discipline as ``tuning/store.py``: concurrent writers
        serialize, re-read the latest state, and atomically rewrite)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        lock_path = str(self.path) + ".lock"
        with open(lock_path, "w") as lf:
            if fcntl is not None:
                fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                with self._lock:
                    self._load(self._stat())  # merge latest on-disk state
                    merged = list(self._records)
                    mutate(merged)
                    fd, tmp = tempfile.mkstemp(
                        dir=str(self.path.parent),
                        prefix=self.path.name + ".", suffix=".tmp")
                    try:
                        with os.fdopen(fd, "w") as f:
                            for line in self._foreign:
                                f.write(line + "\n")
                            for r in merged:
                                f.write(json.dumps(r, separators=(",", ":"))
                                        + "\n")
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, self.path)
                    except BaseException:
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
                        raise
                    self._records = merged
                    self._raw_lines = len(merged) + len(self._foreign)
                    self._stamp = self._stat()
            finally:
                if fcntl is not None:
                    fcntl.flock(lf, fcntl.LOCK_UN)

    def append(self, records: Iterable[Mapping]) -> int:
        """Append history records (see :func:`make_records`); returns how
        many were written."""
        recs = [dict(r) for r in records]
        for r in recs:
            r["schema"] = HISTORY_SCHEMA
            r.setdefault("ts", "")
        if not recs:
            return 0
        self._rewrite_locked(lambda merged: merged.extend(recs))
        return len(recs)

    def compact(self, keep: Optional[int] = None) -> int:
        """Rewrite the file keeping only the newest ``keep`` records per
        (env, section, case) series (default ``$RACE_BENCH_HISTORY_KEEP``,
        128).  Foreign-schema lines are never evicted.  Returns the number
        of records dropped.  A missing file is a no-op — never fabricated.
        """
        keep = keep_limit() if keep is None else int(keep)
        self._compacting = True
        try:
            if self._stat() is None:
                return 0
            dropped = 0

            def mutate(merged):
                nonlocal dropped
                by_series: dict = {}
                for r in merged:
                    k = (r.get("env"), r.get("section"), r.get("case"))
                    by_series.setdefault(k, []).append(r)
                survivors = []
                for series in by_series.values():
                    series.sort(key=lambda r: str(r.get("ts", "")))
                    dropped += max(0, len(series) - keep)
                    survivors.extend(series[-keep:])
                # stable overall order: by ts then series, so rewrites of
                # the same content are byte-identical
                survivors.sort(key=lambda r: (str(r.get("ts", "")),
                                              str(r.get("env", "")),
                                              str(r.get("section", "")),
                                              str(r.get("case", ""))))
                merged[:] = survivors

            self._rewrite_locked(mutate)
        finally:
            self._compacting = False
        return dropped


# ---------------------------------------------------------------------------
# process-wide default history (path re-resolved so env changes take effect)
# ---------------------------------------------------------------------------

_histories: dict = {}
_histories_lock = threading.Lock()


def default_history() -> Optional[BenchHistory]:
    path = history_file()
    if path is None:
        return None
    with _histories_lock:
        h = _histories.get(path)
        if h is None:
            h = _histories[path] = BenchHistory(path)
        return h


def append_rows(section: str, rows, stamp: Mapping,
                history: Optional[BenchHistory] = None) -> int:
    """Benchmark-side front door: append one section's rows to the history
    (no-op when ``$RACE_BENCH_HISTORY`` is unset).  Swallows every failure —
    a benchmark run must never be taken down by its own bookkeeping."""
    try:
        h = history if history is not None else default_history()
        if h is None:
            return 0
        if isinstance(rows, Mapping):  # speedup-style {"cases": [...]}
            rows = rows.get("cases", [])
        n = h.append(make_records(section, rows or [], stamp))
        from .. import obs

        if obs.enabled() and n:
            obs.counter("race_bench_history_records_total",
                        section=section).inc(n)
            obs.event("bench_history_append", section=section, n=n,
                      path=str(h.path))
        return n
    except Exception:
        return 0
