"""Serving launchers of the PyTorch port (``repro/launch/serve.py``): the RACE
serve runtime (``serve_case``)::

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

LM decode (``--arch``, port of the reference's ``decode_arch``): prefill by
teacher-forced decode, then greedy or temperature sampling, on
``--device``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b \
        --reduced --batch 4 --prompt-len 32 --gen 16 --json -
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


def decode_arch(args) -> dict:
    """Prefill ``--prompt-len`` random tokens by teacher-forced decode, then
    generate ``--gen`` more; returns the document it printed.  With
    ``--json`` every step is timed to its end (a device synchronize), and
    the row is appended through :mod:`repro_torch.obs.history`."""
    import numpy as np
    import torch

    from ..configs import get_config
    from ..core.executor import resolve_device
    from ..models import (ExecConfig, init_caches, init_params,
                          make_decode_step)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only; no decode")
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    max_len = args.prompt_len + args.gen
    exec_cfg = ExecConfig(attn_chunk_q=32, attn_chunk_k=32, ssm_chunk=16)
    params = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev)
    caches = init_caches(cfg, args.batch, max_len, device=dev)
    step = make_decode_step(cfg, exec_cfg, max_len)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        device=dev)
    gen = torch.Generator(dev).manual_seed(1)

    # prefill by teacher-forced decode (exercises the cache path end to end)
    t0 = time.time()
    for t in range(args.prompt_len):
        logits, caches = step(params, caches, prompts[:, t:t + 1], t)
    sync()
    prefill_s = time.time() - t0

    generated = []
    # --json wants true per-step latency, so each step must block; the
    # default path keeps launches asynchronous (throughput numbers)
    step_lat = [] if args.json else None
    tok = logits.argmax(-1)[:, None]
    t0 = time.time()
    for t in range(args.prompt_len, max_len):
        generated.append(tok[:, 0])
        t1 = time.perf_counter()
        logits, caches = step(params, caches, tok, t)
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits.argmax(-1)[:, None]
        if step_lat is not None:
            sync()
            step_lat.append(time.perf_counter() - t1)
    sync()
    decode_s = time.time() - t0
    gen_tokens = torch.stack(generated, 1).cpu().numpy()
    doc = {
        "arch": cfg.name, "batch": args.batch,
        "prefill_tok_s": round(args.batch * args.prompt_len / prefill_s, 1),
        "decode_tok_s": round(args.batch * args.gen / decode_s, 1),
        "sample_tokens": gen_tokens[0][:8].tolist(),
    }
    if args.json:
        from ..obs import run_stamp

        lat_us = sorted(s * 1e6 for s in step_lat)
        pick = lambda q: lat_us[min(len(lat_us) - 1,  # noqa: E731
                                    int(q * len(lat_us)))]
        doc.update(
            stamp=run_stamp(), reduced=bool(args.reduced),
            prompt_len=args.prompt_len, gen=args.gen,
            prefill_s=round(prefill_s, 4), decode_s=round(decode_s, 4),
            step_latency_us=[round(s * 1e6, 1) for s in step_lat],
            step_p50_us=round(pick(0.50), 1),
            step_p90_us=round(pick(0.90), 1),
        )
        out = json.dumps(doc, indent=1, default=str)
        if args.json == "-":
            print(out)
        else:
            with open(args.json, "w") as f:
                f.write(out + "\n")
            print(f"wrote {args.json}")
        # decode-latency trajectory: one history row per serve run, keyed
        # like the benchmark sections (no-op without $RACE_BENCH_HISTORY)
        from ..obs.history import append_rows

        append_rows("serve", [doc], doc["stamp"])
    else:
        print(json.dumps(doc))
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serving launchers of the PyTorch port: RACE serve "
                    "runtime (--case) or LM decode (--arch)")
    ap.add_argument("--arch", default=None,
                    help="LM decode mode: model architecture name "
                         "(repro_torch.configs)")
    ap.add_argument("--case", default=None,
                    help="RACE serve mode: registry kernel name "
                         "(repro_torch.apps.paper_kernels)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="LM mode: decode batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--n", type=int, default=None,
                    help="serve mode: grid size (default: case default)")
    ap.add_argument("--requests", type=int, default=64,
                    help="serve mode: total client requests")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="serve mode: closed-loop client threads")
    ap.add_argument("--backend", default=None,
                    help="serve mode: executor backend (default "
                         "$RACE_BACKEND/auto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both modes (default cuda; 'cpu' "
                         "asks for the CPU)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="serve mode: RACE_SERVE_MAX_BATCH override")
    ap.add_argument("--window-us", type=float, default=None,
                    help="serve mode: RACE_SERVE_WINDOW_US override")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="serve mode: kernel library directory (same as "
                         "RACE_COMPILE_CACHE)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="structured output to stdout ('-') or PATH")
    args = ap.parse_args(argv)

    if (args.case is None) == (args.arch is None):
        ap.error("exactly one of --case (RACE serve) or --arch (LM decode) "
                 "is required")
    if args.case is not None:
        serve_case(args)
    else:
        decode_arch(args)


if __name__ == "__main__":
    main()
