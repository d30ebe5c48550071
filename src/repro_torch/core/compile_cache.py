"""Persistent kernel cache of the PyTorch port: zero nvcc runs across
processes.

Port of ``repro/core/compile_cache.py``.  The reference wires JAX's
persistent compilation cache (``jax.config`` and ``jax.monitoring``); none
of that exists here.  The port's persistent cache is the content-addressed
library directory of :mod:`repro_torch.kernels.build`: every kernel source
is compiled once into ``<sha256>.so``, keyed by the source, the ``csrc/``
headers it includes and nvcc's flags, and every later process (or a later
executor of the same plan, after an LRU eviction) loads that library
instead of running nvcc again.

Where the meanings differ from the reference's:

  * the cache is always on.  ``$RACE_COMPILE_CACHE=DIR`` moves the
    directory; unset (or :func:`configure` with ``None``) it is
    ``build/repro_torch/`` at the root of the checkout.  :func:`enabled`
    is therefore always true, and :func:`cache_dir` always names a
    directory;
  * :func:`counts` counts a library found on disk as a ``hit`` and an nvcc
    run as a ``miss``; ``requests`` is their sum, one per source a build
    asked for;
  * nothing is deserialized: a hit is one ``dlopen``.

Telemetry (``RACE_OBS=1``), the reference's names: the
``race_compile_cache_total{event}`` counter and ``compile_cache_hit`` /
``compile_cache_miss`` events with the directory, and a
``compile_cache_configure`` event when the directory changes.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from .. import obs as _obs

#: env knob (documented in README): directory of the kernel libraries
ENV_COMPILE_CACHE = "RACE_COMPILE_CACHE"

_lock = threading.RLock()
_active_path: Optional[str] = None  # None: the default build directory
_env_seen: Optional[str] = None  # last $RACE_COMPILE_CACHE value applied
_counts = {"hits": 0, "misses": 0, "requests": 0}


def record(event: str, path) -> None:
    """Count one library lookup of the build: ``"hit"`` (found on disk) or
    ``"miss"`` (nvcc runs)."""
    with _lock:
        _counts["hits" if event == "hit" else "misses"] += 1
        _counts["requests"] += 1
    if _obs.enabled():
        _obs.counter("race_compile_cache_total", event=event).inc()
        _obs.event(f"compile_cache_{event}", path=str(path))


def configure(path: Optional[str]) -> bool:
    """Build kernel libraries into ``path`` (``None``: the default
    ``build/repro_torch/``).  Idempotent; returns :func:`enabled`."""
    global _active_path
    with _lock:
        path = path or None
        if path == _active_path:
            return True
        if path:
            os.makedirs(path, exist_ok=True)
        _active_path = path
    if _obs.enabled():
        _obs.event("compile_cache_configure", path=cache_dir(),
                   enabled=True)
    return True


def ensure_enabled() -> bool:
    """Apply ``$RACE_COMPILE_CACHE`` if it changed since last seen: one env
    read when nothing changed.  An explicit :func:`configure` call wins
    until the env value changes again."""
    global _env_seen
    raw = os.environ.get(ENV_COMPILE_CACHE, "").strip()
    if raw == _env_seen:
        return True
    with _lock:
        if raw != _env_seen:
            configure(raw or None)
            _env_seen = raw
    return True


def enabled() -> bool:
    """Always true: the library directory is the cache (see the module
    docstring)."""
    return True


def cache_dir() -> str:
    """The directory kernel libraries are built into and loaded from."""
    if _active_path:
        return _active_path
    from ..kernels.build import BUILD_DIR

    return str(BUILD_DIR)


def counts() -> dict:
    """Snapshot of this process's library lookups."""
    with _lock:
        return dict(_counts)


def info() -> dict:
    """Enabled flag, directory, built libraries on disk, and traffic."""
    path = cache_dir()
    try:
        n_entries = sum(1 for f in os.listdir(path) if f.endswith(".so"))
    except OSError:
        n_entries = 0
    return dict(enabled=True, path=path, entries=n_entries, **counts())
