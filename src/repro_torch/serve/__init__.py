"""``repro_torch.serve`` — RACE as a service on the PyTorch port (port of
``repro.serve``).

Once RACE has eliminated redundant *computation* (detection) and redundant
*compilation* (the executor cache and the kernel library directory), the
remaining redundancy is per-request *dispatch* — eliminated here by
coalescing concurrent same-specialization requests into one ``run_batch``:
on ``"hopper"`` one K1 launch per batch.

    runtime.py  ServeRuntime: plan-hash dynamic batching, bounded queue,
                worker pool, structured ServeRejected backpressure
    warm.py     zero cold start: eager warmup() API, synthetic envs from
                stored signatures, tuning-store replay CLI
                (``python -m repro_torch.serve.warm``)

Entry points (each on ``cuda`` unless given ``device="cpu"``)::

    with ServeRuntime() as rt:
        fut = rt.submit(res, env)       # non-blocking, returns a Future
        out = rt.run(res, env)          # blocking convenience (numpy out)
    warmup([(res, env), ...])           # build executors before traffic
    python -m repro_torch.serve.warm    # replay the tuning store

Knobs: ``RACE_SERVE_MAX_BATCH``, ``RACE_SERVE_WINDOW_US``,
``RACE_SERVE_QUEUE``, ``RACE_SERVE_WORKERS`` (runtime) and
``RACE_COMPILE_CACHE`` (the kernel library directory; see
:mod:`repro_torch.core.compile_cache`).
"""
from .runtime import (ENV_MAX_BATCH, ENV_QUEUE, ENV_WINDOW_US, ENV_WORKERS,
                      ServeRejected, ServeRuntime)

__all__ = [
    "ServeRuntime", "ServeRejected", "warmup", "warm_from_store",
    "synthetic_env", "ENV_MAX_BATCH", "ENV_WINDOW_US", "ENV_QUEUE",
    "ENV_WORKERS",
]

_WARM = ("warmup", "warm_from_store", "synthetic_env")


def __getattr__(name):
    # .warm is imported lazily so ``python -m repro_torch.serve.warm``
    # doesn't trip the runpy found-in-sys.modules warning on package import
    if name in _WARM:
        from . import warm

        return getattr(warm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
