"""Persistent, crash-safe store of autotuning decisions (PyTorch port).

Port of ``repro/tuning/store.py``: the same file format, knobs and
durability contract.  One JSON-lines file — ``$RACE_TUNING_CACHE`` (a
directory, or a ``*.jsonl`` file path) or
``~/.cache/repro-race/tuning.jsonl`` — holds one record per line.  Records
are keyed by

    (kind, structural hash, env signature, device, torch + CUDA versions)

where ``kind`` is ``"program"`` (the tuner's full decision, reassociation
level included) or ``"plan"`` (backend + block config for one already-chosen
plan — what ``compile_plan(..., backend="auto")`` consults), the structural
hash is :func:`repro_torch.core.executor.program_hash` / ``plan_hash``
(equal to the reference's for equal programs), the signature is the port's
three-field ``(name, shape, dtype)`` form, and the runtime fence is the
card's name with the torch and CUDA versions (``"cpu"`` on the CPU).

Every record carries ``schema`` = :data:`SCHEMA_VERSION`, a tag of the
port's own (``"torch-1"``), so both packages can share one store file: the
reference's records (schema ``1``) are foreign here and the port's are
foreign there, so a JAX record never answers a torch lookup, and each
package keeps the other's lines verbatim through its rewrites.

Durability contract (pinned by tests):

  * writes are *atomic renames* — readers never observe a truncated file —
    and serialized by an advisory ``flock`` on a sidecar lock file, so two
    concurrent writers merge rather than lose records;
  * loading is fully tolerant: corrupt or truncated lines, wrong-schema
    records, and unreadable files all degrade to "no record" (the tuner
    simply re-measures); the store never raises on bad input;
  * other-schema lines are *preserved verbatim* through rewrites and
    compaction (deduped by their own (schema, key));
  * stores stay bounded on long-lived machines: the JSONL format is
    last-line-wins, so :meth:`TuningStore.compact` rewrites the file keeping
    only the newest record per key — invoked automatically when a read sees
    the file exceed :data:`COMPACT_LINE_THRESHOLD` physical lines with
    stale (duplicate-key or old-schema) lines among them.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Mapping, Optional

SCHEMA_VERSION = "torch-1"

ENV_STORE = "RACE_TUNING_CACHE"
#: record-hygiene knobs, applied during :meth:`TuningStore.compact`:
#:   RACE_TUNING_MAX_AGE_DAYS — drop records older than this many days
#:     (records written before the ``ts`` field existed count as age 0 of
#:     the epoch, i.e. oldest — they re-tune once and come back stamped);
#:   RACE_TUNING_MAX_RECORDS  — keep only the newest N records by ``ts``.
ENV_MAX_AGE_DAYS = "RACE_TUNING_MAX_AGE_DAYS"
ENV_MAX_RECORDS = "RACE_TUNING_MAX_RECORDS"


def eviction_limits() -> tuple:
    """``(max_age_seconds | None, max_records | None)`` from the env."""
    out = []
    for var, scale in ((ENV_MAX_AGE_DAYS, 86400.0), (ENV_MAX_RECORDS, 1)):
        raw = os.environ.get(var, "").strip()
        if not raw:
            out.append(None)
            continue
        try:
            v = float(raw) * scale
        except ValueError:
            raise ValueError(f"{var}={raw!r} is not a number") from None
        if v <= 0:
            raise ValueError(f"{var} must be > 0, got {raw}")
        out.append(int(v) if scale == 1 else v)
    return tuple(out)


def _select_evictions(records: Mapping, max_age, max_records,
                      now: Optional[float] = None) -> list:
    """Keys to drop under the age/size limits (newest-by-``ts`` survive;
    records without a ``ts`` stamp sort oldest)."""
    if max_age is None and max_records is None:
        return []
    now = time.time() if now is None else now
    doomed = []
    alive = []
    for key, rec in records.items():
        ts = rec.get("ts")
        ts = float(ts) if isinstance(ts, (int, float)) else 0.0
        if max_age is not None and now - ts > max_age:
            doomed.append(key)
        else:
            alive.append((ts, key))
    if max_records is not None and len(alive) > max_records:
        alive.sort()  # oldest first
        doomed.extend(key for _, key in alive[:len(alive) - max_records])
    return doomed

try:  # POSIX advisory locking; harmlessly absent elsewhere
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None


def store_file() -> Path:
    """Resolve the store path from ``$RACE_TUNING_CACHE`` (file or dir)."""
    raw = os.environ.get(ENV_STORE, "").strip()
    if raw:
        p = Path(raw).expanduser()
        return p if p.suffix == ".jsonl" else p / "tuning.jsonl"
    return Path.home() / ".cache" / "repro-race" / "tuning.jsonl"


_fences: dict = {}


def runtime_fence(device=None) -> dict:
    """The runtime a record was measured on: records never cross it.

    ``device`` names the torch device (``None``: ``cuda`` where a card is
    present, else the CPU).  On a card: its name
    (``torch.cuda.get_device_name``) with ``torch.__version__`` and
    ``torch.version.cuda``; on the CPU, ``"cpu"`` and the torch version.
    Memoized per device — none of it changes within a process, and the
    serving path asks on every ``backend="auto"`` compile."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    key = str(dev)
    f = _fences.get(key)
    if f is None:
        if dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
            cuda = torch.version.cuda
        else:
            name, cuda = dev.type, None
        f = _fences[key] = dict(device=name, torch=torch.__version__,
                                cuda=cuda)
    return f


def runtime_token(fence: Mapping) -> str:
    """The runtime versions of a fence as one key field."""
    return f"torch={fence['torch']}+cuda={fence['cuda']}"


def sig_json(sig: tuple) -> str:
    """Canonical JSON of an env signature (the port's three-field form;
    torch has no weak types)."""
    return json.dumps([[nm, list(shape), str(dt)] for nm, shape, dt in sig],
                      separators=(",", ":"))


def record_key(kind: str, struct_hash: str, sig: tuple,
               fence: Optional[Mapping] = None, opts: str = "",
               batch: int = 0) -> str:
    """Store key.  ``opts`` is a canonical token of the *search-shaping*
    options (program-kind records only): a decision found by a narrower
    search (``backends=("xla",)``, restricted ``levels``, ...) must never
    answer a later full-space request, so the searched space is part of the
    record's identity.  ``batch > 0`` marks a record measured on the
    *batched* executor at that batch size — a separate population from
    per-call records (``batch=0``, the historical key shape, unchanged
    so existing stores stay live).  ``fence`` defaults to
    :func:`runtime_fence` of the default device."""
    f = fence or runtime_fence()
    parts = [kind, struct_hash, sig_json(sig), str(f["device"]),
             runtime_token(f)]
    if opts:
        parts.append(opts)
    if batch > 0:
        parts.append(f"batch={int(batch)}")
    return "|".join(parts)


#: auto-compaction threshold: when a load sees more raw lines than live
#: records and the file exceeds this many lines, the next read triggers
#: :meth:`TuningStore.compact` (long-lived machines accumulate stale lines
#: from older schema versions or append-mode writers).
COMPACT_LINE_THRESHOLD = 1024


class TuningStore:
    """Mtime-checked in-memory view over one JSON-lines store file."""

    def __init__(self, path, compact_threshold: int = COMPACT_LINE_THRESHOLD):
        self.path = Path(path)
        self.compact_threshold = compact_threshold
        self._records: dict = {}
        # raw lines of *other* schema versions, preserved verbatim across
        # rewrites (keyed by (schema, key) so stale duplicates still compact)
        self._foreign: dict = {}
        self._raw_lines = 0  # physical lines last seen on disk
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
        records: dict = {}
        foreign: dict = {}
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
                    or rec.get("schema") != SCHEMA_VERSION
                    or not isinstance(rec.get("key"), str)):
                # Other-schema records are invisible to this version but must
                # survive rewrites: a newer (or older) library sharing the
                # store file still owns them.  Keep the raw line verbatim,
                # deduped by (schema, key) so compaction still collapses
                # stale duplicates; truly malformed lines stay dropped.
                if isinstance(rec, dict) and "schema" in rec:
                    fk = (repr(rec.get("schema")),
                          rec["key"] if isinstance(rec.get("key"), str)
                          else f"#line{n_lines}")
                    foreign[fk] = line  # later lines win
                continue
            records[rec["key"]] = rec  # later lines win
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
        """Best-effort compaction when the on-disk file has grown past the
        line threshold with stale lines (duplicate keys, old schemas).
        Never raises — a read must not be taken down by a failed rewrite."""
        if (self._compacting
                or self._raw_lines <= self.compact_threshold
                or self._raw_lines <= len(self._records) + len(self._foreign)):
            return
        try:
            self.compact()
        except Exception:  # pragma: no cover - e.g. read-only store dir
            pass

    # -- read ---------------------------------------------------------------

    def get(self, key: str) -> Optional[dict]:
        self._maybe_reload()
        return self._records.get(key)

    def __len__(self) -> int:
        self._maybe_reload()
        return len(self._records)

    def keys(self) -> list:
        self._maybe_reload()
        return list(self._records)

    # -- write --------------------------------------------------------------

    def _rewrite_locked(self, mutate) -> None:
        """Read-merge-replace under the advisory file lock.

        Concurrent writers from any number of processes serialize on the
        lock, each re-reads the latest on-disk state, applies ``mutate`` to
        the live record dict, and atomically rewrites; the ``os.replace``
        keeps every intermediate state a complete, valid JSON-lines file.
        """
        self.path.parent.mkdir(parents=True, exist_ok=True)
        lock_path = str(self.path) + ".lock"
        with open(lock_path, "w") as lf:
            if fcntl is not None:
                fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                with self._lock:
                    self._load(self._stat())  # merge latest on-disk state
                    merged = dict(self._records)
                    mutate(merged)
                    fd, tmp = tempfile.mkstemp(
                        dir=str(self.path.parent),
                        prefix=self.path.name + ".", suffix=".tmp")
                    try:
                        with os.fdopen(fd, "w") as f:
                            # other-schema lines first: they belong to other
                            # library versions and must round-trip verbatim
                            for line in self._foreign.values():
                                f.write(line + "\n")
                            for r in merged.values():
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

    def put(self, record: Mapping) -> None:
        """Merge one record (by its ``key``) and atomically rewrite the file
        (see :meth:`_rewrite_locked` for the durability contract)."""
        rec = dict(record)
        rec["schema"] = SCHEMA_VERSION
        rec.setdefault("ts", time.time())  # age-eviction stamp (compact())
        if not isinstance(rec.get("key"), str):
            raise ValueError("tuning record needs a string 'key'")
        self._rewrite_locked(lambda merged: merged.__setitem__(rec["key"],
                                                               rec))

    def compact(self, now: Optional[float] = None) -> int:
        """Rewrite the store keeping only the newest record per key, minus
        any records the hygiene limits evict.

        The JSONL format is last-line-wins, so files written by append-mode
        writers (or carrying lines from older schema versions) accumulate
        stale lines that every load must scan and skip.  Compaction rewrites
        the file from the live record view — one line per key, newest wins —
        under the same flock + atomic-rename discipline as :meth:`put`, and
        is invoked automatically by reads once the file exceeds
        ``compact_threshold`` physical lines (see ``_maybe_autocompact``).

        Record hygiene rides the same rewrite: when
        ``$RACE_TUNING_MAX_AGE_DAYS`` / ``$RACE_TUNING_MAX_RECORDS`` are
        set, records older than the age limit (by their ``ts`` write stamp;
        pre-stamp records count as oldest) and records beyond the newest-N
        size limit are dropped.  Foreign-schema lines are *never* evicted —
        they belong to other library versions and round-trip verbatim.
        Returns the number of physical lines removed.

        A missing or already-compact store (with no evictions due) is a
        no-op: nothing is created or rewritten (gratuitous churn would
        defeat the mtime-stamped reload every reader relies on).
        """
        self._compacting = True  # guards the _maybe_reload -> auto recursion
        try:
            if self._stat() is None:
                return 0  # no store on disk: never fabricate one
            self._maybe_reload()
            max_age, max_records = eviction_limits()
            if (self._raw_lines <= len(self._records) + len(self._foreign)
                    and not _select_evictions(self._records, max_age,
                                              max_records, now=now)):
                return 0  # one line per live key already, nothing to evict
            removed = 0
            evicted = 0

            def mutate(merged):
                # _rewrite_locked just re-read the file under the flock, so
                # _raw_lines is the authoritative on-disk count (no second
                # unlocked read, no racy arithmetic)
                nonlocal removed, evicted
                doomed = _select_evictions(merged, max_age, max_records,
                                           now=now)
                for key in doomed:
                    del merged[key]
                evicted = len(doomed)
                removed = max(0, self._raw_lines - len(merged)
                              - len(self._foreign))

            self._rewrite_locked(mutate)
            if evicted:
                from .. import obs

                if obs.enabled():
                    obs.counter("race_tuning_store_evictions_total").inc(
                        evicted)
                    obs.event("tuning_store_evict", path=str(self.path),
                              evicted=evicted, removed_lines=removed,
                              max_age_s=max_age, max_records=max_records)
        finally:
            self._compacting = False
        return removed


# ---------------------------------------------------------------------------
# process-wide default store (path re-resolved so env changes take effect)
# ---------------------------------------------------------------------------

_stores: dict = {}
_stores_by_env: dict = {}  # ($RACE_TUNING_CACHE, $HOME) -> store
_stores_lock = threading.Lock()


def default_store() -> TuningStore:
    """The process-wide store of :func:`store_file`'s path.  The serving
    path asks on every ``backend="auto"`` call, so the path is resolved
    once per value of the variables it is made from."""
    env = (os.environ.get(ENV_STORE, ""), os.environ.get("HOME", ""))
    s = _stores_by_env.get(env)
    if s is None:
        path = store_file()
        with _stores_lock:
            s = _stores.get(path)
            if s is None:
                s = _stores[path] = TuningStore(path)
            _stores_by_env[env] = s
    return s


def plan_choice(key: str,
                store: Optional[TuningStore] = None) -> Optional[dict]:
    """The recorded backend/block choice under a prebuilt plan-kind ``key``
    (see :func:`record_key`), or None.  Swallows every failure — the serving
    path calls this on each ``backend="auto"`` compile and must never be
    taken down by the store."""
    try:
        s = store if store is not None else default_store()
        rec = s.get(key)
        if rec is not None and isinstance(rec.get("choice"), dict):
            return rec["choice"]
    except Exception:
        pass
    return None


def plan_batch_choice(struct_hash: str, sig: tuple, batch: int,
                      store: Optional[TuningStore] = None,
                      fence: Optional[Mapping] = None) -> Optional[dict]:
    """Best recorded choice for the *batched* executor of one plan.

    Exact ``batch`` match wins; otherwise the nearest recorded batch size by
    log-ratio answers (a config tuned at batch 8 is a far better guess for
    batch 6 than the single-call record).  Returns None — never raises —
    when nothing batched was ever recorded for this plan + signature.
    """
    try:
        s = store if store is not None else default_store()
        exact = s.get(record_key("plan", struct_hash, sig, fence,
                                 batch=batch))
        if exact is not None and isinstance(exact.get("choice"), dict):
            return exact["choice"]
        prefix = record_key("plan", struct_hash, sig, fence) + "|batch="
        best, best_dist = None, None
        for key in s.keys():
            if not key.startswith(prefix):
                continue
            try:
                b = int(key[len(prefix):])
            except ValueError:
                continue
            if b < 1:
                continue
            dist = abs(math.log(b / max(1, batch)))
            if best_dist is None or dist < best_dist:
                rec = s.get(key)
                if rec is not None and isinstance(rec.get("choice"), dict):
                    best, best_dist = rec["choice"], dist
        return best
    except Exception:
        return None


def program_record(program_hash: str, sig: tuple,
                   store: Optional[TuningStore] = None,
                   opts: str = "",
                   fence: Optional[Mapping] = None) -> Optional[dict]:
    """The tuner's full decision record for one program + env signature +
    search-options token (see :func:`record_key`)."""
    try:
        s = store if store is not None else default_store()
        return s.get(record_key("program", program_hash, sig, fence,
                                opts=opts))
    except Exception:
        return None
