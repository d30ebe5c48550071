"""Serving launcher of the PyTorch port: the RACE serve runtime (port of
``repro/launch/serve.py``'s ``serve_case``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --case j3d27pt \
        --n 64 --requests 512 --concurrency 8 --json BENCH_serve.json

drives :class:`repro_torch.serve.ServeRuntime` on ``--device`` (default
``cuda``, which needs a card) with closed-loop client threads — every
client submits one blocking request at a time, so ``--concurrency`` is the
number of requests in flight and the runtime's batching window does the
coalescing.  Reports per-request p50/p95 latency, sustained rps, the
runtime's coalescing stats, and the state of the kernel library directory
the warmup found (``warm``: every library on disk; ``cold``: nvcc ran).
The row is appended through :mod:`repro_torch.obs.history` (when
``$RACE_BENCH_HISTORY`` is set).

The reference's LM decode path (``--arch``) waits for the port of the LM
stack.
"""
from __future__ import annotations

import argparse
import json
import time


def serve_case(args) -> dict:
    """Run one serving measurement; returns the row it printed."""
    import threading

    from ..apps.paper_kernels import get_case
    from ..core import compile_cache
    from ..core.race import race
    from ..obs import run_stamp
    from ..serve import ServeRuntime
    from ..testing.differential import build_env

    if args.compile_cache:
        compile_cache.configure(args.compile_cache)
    else:
        compile_cache.ensure_enabled()

    case = get_case(args.case, args.n)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    envs = [build_env(case, seed=s) for s in range(max(args.concurrency, 8))]

    rt = ServeRuntime(max_batch=args.max_batch, window_us=args.window_us,
                      backend=args.backend, device=args.device)
    try:
        cc0 = compile_cache.counts()
        warm = rt.warmup([(res.plan, envs[0])], backend=args.backend)
        cc1 = compile_cache.counts()
        cc_state = "cold" if cc1["misses"] > cc0["misses"] else "warm"

        per_client = max(1, args.requests // args.concurrency)
        lat_lock = threading.Lock()
        lat_us: list = []
        errors: list = []

        def client(idx: int) -> None:
            mine = []
            for i in range(per_client):
                env = envs[(idx + i) % len(envs)]
                t0 = time.perf_counter()
                try:
                    rt.run(res.plan, env, backend=args.backend, timeout=300)
                except Exception as e:  # noqa: BLE001 - reported, not fatal
                    with lat_lock:
                        errors.append(repr(e))
                    return
                mine.append((time.perf_counter() - t0) * 1e6)
            with lat_lock:
                lat_us.extend(mine)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(args.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0
        stats = rt.stats()
    finally:
        rt.close()

    if errors:
        raise SystemExit(f"serve clients failed: {errors[:3]} "
                         f"(+{max(0, len(errors) - 3)} more)")
    lat = sorted(lat_us)
    pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
    done = len(lat)
    row = {
        "case": case.name, "n": args.n, "backend": args.backend,
        "device": str(rt.device), "tag": "serve",
        "concurrency": args.concurrency,
        "batch": stats["max_batch_limit"], "compile_cache": cc_state,
        "warm_library_hits": cc1["hits"] - cc0["hits"],
        "warm_nvcc_runs": cc1["misses"] - cc0["misses"],
        "requests": done, "rps": round(done / max(wall_s, 1e-9), 1),
        "p50_us": round(pick(0.50), 1), "p95_us": round(pick(0.95), 1),
        "warm_build_ms": warm[0]["build_ms"],
        "warm_first_ms": warm[0]["first_ms"],
        "batches": stats["batches"], "coalesced": stats["coalesced"],
        "max_batch_seen": stats["max_batch"],
        "rejected": stats["rejected"],
    }
    doc = {"stamp": run_stamp(), "section": "serve", "rows": [row]}
    out = json.dumps(doc, indent=1, default=str)
    if args.json and args.json != "-":
        with open(args.json, "w") as f:
            f.write(out + "\n")
        print(f"wrote {args.json}")
    else:
        print(out)
    print(f"serve {case.name} n={args.n} x{done}: rps={row['rps']} "
          f"p50={row['p50_us']}us p95={row['p95_us']}us "
          f"batches={row['batches']} coalesced={row['coalesced']} "
          f"compile_cache={cc_state} (library hits "
          f"{row['warm_library_hits']}, nvcc runs {row['warm_nvcc_runs']})")
    from ..obs.history import append_rows

    append_rows("serve", [row], doc["stamp"])
    from .. import obs

    if obs.enabled():
        obs.dump("OBS_metrics.json")
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="RACE serve runtime on the PyTorch port: closed-loop "
                    "clients against one registry kernel")
    ap.add_argument("--case", required=True,
                    help="registry kernel name (repro_torch.apps."
                         "paper_kernels)")
    ap.add_argument("--n", type=int, default=None,
                    help="grid size (default: case default)")
    ap.add_argument("--requests", type=int, default=64,
                    help="total client requests")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop client threads")
    ap.add_argument("--backend", default=None,
                    help="executor backend (default $RACE_BACKEND/auto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' asks for the "
                         "CPU)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="RACE_SERVE_MAX_BATCH override")
    ap.add_argument("--window-us", type=float, default=None,
                    help="RACE_SERVE_WINDOW_US override")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="kernel library directory (same as "
                         "RACE_COMPILE_CACHE)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="structured output to stdout ('-') or PATH")
    serve_case(ap.parse_args(argv))


if __name__ == "__main__":
    main()
