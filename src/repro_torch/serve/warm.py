"""Eager warmup: build executors before traffic, replay the tuning store
(PyTorch port of ``repro/serve/warm.py``).

Zero cold start has two halves.  The kernel library directory
(:mod:`repro_torch.core.compile_cache`) makes a *rebuild* cheap — K1's
library is loaded from disk instead of running nvcc — but something still
has to trigger the executor build and the first launch before the first
real request arrives.  This module is that something:

  * :func:`warmup` — eagerly build + first-call a list of (plan |
    RaceResult, env | signature) pairs on a device, reporting per-item build
    and first-call wall times plus the library lookups they made;
  * :func:`synthetic_env` — fabricate a valid environment from a bare
    :func:`~repro_torch.core.executor.env_signature` (what the tuning store
    records), so warmup needs no real data;
  * :func:`warm_from_store` / the ``python -m repro_torch.serve.warm`` CLI
    — replay the tuning store's plan-kind records: each records the exact
    (plan hash, env signature) a past process tuned, and the registry
    (:mod:`repro_torch.apps.paper_kernels`) lets us rebuild the matching
    program, so a fresh process reaches steady-state latency before opening
    its queue.  ``"auto"`` then builds each executor with the record's
    blocks.

The store records only hashes, not programs — replay works by re-deriving
candidate programs from the registry at sizes inferred from the stored
signatures and matching structural hashes.  A stored signature may leave a
program's output arrays out (the port's kernel makes its outputs).  Records
whose program is not in the registry (user-defined kernels) are reported as
``unmatched``; warm those through :func:`warmup` with the live objects
instead.
"""
from __future__ import annotations

import json
import time
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from .. import obs as _obs
from ..core import compile_cache
from ..core.depgraph import Plan
from ..core.executor import (compile_plan, env_to_torch, plan_hash,
                             resolve_device)

#: reassociation levels replay tries when matching a stored plan hash
REPLAY_LEVELS = (0, 3, 4)


def synthetic_env(sig: Sequence[tuple], device=None) -> dict:
    """A valid environment fabricated from an env signature, as tensors on
    ``device`` (``None``: the CPU).

    Every floating entry is 0.5 (safely inside the well-conditioned range
    the differential harness draws from), integer entries 1, booleans True;
    scalars are 0-d tensors of the signature's dtype, so the fabricated env
    round-trips to *exactly* the input signature — the executor key must
    match the one real traffic will use."""
    env = {}
    for nm, shape, dtype in sig:
        dt = getattr(torch, str(dtype))
        fill = (0.5 if dt.is_floating_point or dt.is_complex
                else True if dt == torch.bool else 1)
        env[nm] = torch.full(tuple(shape), fill, dtype=dt, device=device)
    return env


def _as_plan(target: Union[Plan, "object"]) -> Plan:
    plan = getattr(target, "plan", target)
    if not isinstance(plan, Plan):
        raise TypeError(f"warmup target must be a Plan or RaceResult, got "
                        f"{type(target).__name__}")
    return plan


def warmup(items: Sequence[Tuple[object, Union[Mapping, tuple]]], *,
           backend: Optional[str] = None, run: bool = True,
           device=None) -> list:
    """Eagerly build the executor for each (target, env-or-signature) pair
    on ``device`` (``None``: cuda, raising without a card).

    Each item's first call on a card loads K1's library — built by nvcc
    only when the library directory does not hold it yet — and launches it,
    ending in a synchronize, so the first *real* request finds both the
    executor cache and the library hot.  Returns one report dict per item:
    ``build_ms`` (executor specialization), ``first_ms`` (first call: the
    library load or build and one launch), and the library lookups the item
    made (``cache_hits`` found on disk, ``cache_misses`` nvcc runs).
    """
    dev = resolve_device(device)
    reports = []
    for target, env in items:
        plan = _as_plan(target)
        if isinstance(env, tuple):
            env = synthetic_env(env, dev)
        c0 = compile_cache.counts()
        t0 = time.perf_counter()
        env = env_to_torch(env, dev)
        ex = compile_plan(plan, env, backend)
        build_ms = (time.perf_counter() - t0) * 1e3
        first_ms = None
        if run:
            t1 = time.perf_counter()
            ex.run(env)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            first_ms = (time.perf_counter() - t1) * 1e3
        c1 = compile_cache.counts()
        rep = dict(plan=plan_hash(plan), backend=ex.backend,
                   blocks=list(ex.spec.tp.geometry.tile)
                   if ex.spec is not None else None,
                   build_ms=round(build_ms, 3),
                   first_ms=None if first_ms is None else round(first_ms, 3),
                   cache_hits=c1["hits"] - c0["hits"],
                   cache_misses=c1["misses"] - c0["misses"])
        if _obs.enabled():
            _obs.event("serve_warmup", **rep)
        reports.append(rep)
    return reports


# ---------------------------------------------------------------------------
# tuning-store replay
# ---------------------------------------------------------------------------


def store_plan_keys(store=None, device=None) -> list:
    """``(plan_hash, env signature, batch)`` for every plan-kind record in
    the tuning store matching the runtime fence of ``device`` (``None``:
    cuda where a card is present, else the CPU).  Tolerant of malformed
    keys (skipped) and a missing store (empty list)."""
    from ..tuning.store import (default_store, runtime_fence, runtime_token,
                                sig_json)

    try:
        s = store if store is not None else default_store()
        fence = runtime_fence(device)
        out = []
        for key in s.keys():
            parts = key.split("|")
            if len(parts) < 5 or parts[0] != "plan":
                continue
            if (parts[3] != str(fence["device"])
                    or parts[4] != runtime_token(fence)):
                continue
            batch = 0
            if len(parts) >= 6 and parts[5].startswith("batch="):
                try:
                    batch = int(parts[5][len("batch="):])
                except ValueError:
                    continue
            try:
                sig = tuple((nm, tuple(shape), dt)
                            for nm, shape, dt in json.loads(parts[2]))
            except Exception:
                continue
            if sig_json(sig) != parts[2]:  # round-trip guard
                continue
            out.append((parts[1], sig, batch))
        return out
    except Exception:
        return []


def _candidate_sizes(sig: tuple, max_halo: int = 6) -> list:
    """Grid sizes that could have produced these array dims: every stored
    dimension minus a plausible halo margin (stencil halos are small)."""
    dims = sorted({d for _, shape, _ in sig for d in shape})
    return sorted({d - k for d in dims for k in range(max_halo + 1)
                   if d - k >= 2}, reverse=True)


def _sig_fits(case, sig: tuple) -> bool:
    """The case's arrays at their registry shapes: every name of ``sig`` is
    one of the program's, at its required shape, and only outputs may be
    left out.  Cheap: no data, no detection."""
    from ..core.codegen import required_shapes

    shapes = required_shapes(case.program)
    outs = {st.lhs.name for st in case.program.body}
    got = {nm: tuple(shape) for nm, shape, _ in sig}
    return (set(got) <= set(shapes) and set(shapes) - outs <= set(got)
            and all(shapes[nm] == shp for nm, shp in got.items()))


def _match_record(ph: str, sig: tuple, *, levels=REPLAY_LEVELS,
                  _memo: Optional[dict] = None) -> Optional[Plan]:
    """Rebuild the registry program whose plan hashes to ``ph`` at ``sig``.

    For each registry case at each candidate size, the signature's names
    and shapes must fit the case (:func:`_sig_fits`), and only then are
    plans derived at each replay level and hash-compared.  Returns the
    matching plan or None."""
    from ..apps.paper_kernels import CASES, get_case
    from ..core.race import race

    for name in CASES:
        for n in _candidate_sizes(sig):
            memo_key = (name, n)
            if _memo is not None and memo_key in _memo:
                case = _memo[memo_key]
            else:
                try:
                    case = get_case(name, n)
                except Exception:
                    case = None
                if _memo is not None:
                    _memo[memo_key] = case
            if case is None:
                continue
            try:
                if not _sig_fits(case, sig):
                    continue
                for lvl in dict.fromkeys(
                        (case.reassociate,) + tuple(levels)):
                    res = race(case.program, reassociate=lvl,
                               rewrite_div=case.rewrite_div)
                    if plan_hash(res.plan) == ph:
                        return res.plan
            except Exception:
                continue
    return None


def warm_from_store(store=None, *, backend: Optional[str] = None,
                    levels=REPLAY_LEVELS, device=None) -> dict:
    """Replay every fence-matching plan record on ``device`` (``None``:
    cuda, raising without a card): rebuild + first-call each.

    Returns ``{warmed: [report...], unmatched: [plan hash...]}`` — an
    unmatched hash is a plan whose program is not derivable from the
    registry (a user-defined kernel tuned in some earlier process).
    """
    dev = resolve_device(device)
    records = store_plan_keys(store, dev)
    seen = set()
    items = []
    unmatched = []
    memo: dict = {}
    for ph, sig, _batch in records:
        if (ph, sig) in seen:
            continue
        seen.add((ph, sig))
        plan = _match_record(ph, sig, levels=levels, _memo=memo)
        if plan is None:
            unmatched.append(ph)
        else:
            items.append((plan, sig))
    reports = warmup(items, backend=backend, device=dev)
    if _obs.enabled():
        _obs.event("serve_warm_replay", records=len(records),
                   warmed=len(reports), unmatched=len(unmatched))
    return dict(warmed=reports, unmatched=sorted(set(unmatched)))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="eager executor warmup (zero cold start). Default: "
                    "replay the tuning store's plan records; --cases warms "
                    "named registry kernels directly.")
    ap.add_argument("--cases", default=None,
                    help="comma list of registry case names to warm "
                         "(instead of store replay)")
    ap.add_argument("--sizes", default=None,
                    help="comma list of grid sizes for --cases "
                         "(default: each case's registry default)")
    ap.add_argument("--levels", default=None,
                    help="comma list of reassociation levels for --cases "
                         "(default: each case's own level)")
    ap.add_argument("--backend", default=None,
                    help="backend to warm (default $RACE_BACKEND/auto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to warm on (default cuda; 'cpu' "
                         "asks for the CPU)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH", help="structured report to stdout or PATH")
    args = ap.parse_args(argv)

    if args.cases:
        from ..apps.paper_kernels import get_case
        from ..core.race import race
        from ..testing.differential import build_env

        sizes = ([int(s) for s in args.sizes.split(",")]
                 if args.sizes else [None])
        items = []
        for name in args.cases.split(","):
            for n in sizes:
                case = get_case(name.strip(), n)
                levels = ([int(v) for v in args.levels.split(",")]
                          if args.levels else [case.reassociate])
                for lvl in levels:
                    res = race(case.program, reassociate=lvl,
                               rewrite_div=case.rewrite_div)
                    items.append((res.plan, build_env(case)))
        doc = dict(warmed=warmup(items, backend=args.backend,
                                 device=args.device), unmatched=[])
    else:
        doc = warm_from_store(backend=args.backend, device=args.device)

    doc["compile_cache"] = compile_cache.info()
    n_w, n_u = len(doc["warmed"]), len(doc["unmatched"])
    if args.json:
        out = json.dumps(doc, indent=1)
        if args.json == "-":
            print(out)
        else:
            with open(args.json, "w") as f:
                f.write(out + "\n")
            print(f"wrote {args.json}")
    else:
        for rep in doc["warmed"]:
            print(f"warm plan={rep['plan']} backend={rep['backend']} "
                  f"blocks={rep['blocks']} build={rep['build_ms']}ms "
                  f"first={rep['first_ms']}ms "
                  f"cache_hits={rep['cache_hits']} "
                  f"cache_misses={rep['cache_misses']}")
        print(f"warmed={n_w} unmatched={n_u} "
              f"compile_cache={doc['compile_cache']}")


if __name__ == "__main__":
    main()
