"""``autotune`` — measured, correctness-gated, persisted strategy selection
(PyTorch port).

Port of ``repro/tuning/tuner.py``: given a
:class:`~repro_torch.core.ir.Program` and a concrete environment, enumerate
the candidate space (:mod:`.space`), measure every candidate through the
executor serving path (:mod:`.measure`) on ``device``, gate each against
the ``reassociate=0`` ``"torch"`` output, and persist the winner
(:mod:`.store`) keyed by (structural hash, env signature, card, torch and
CUDA versions) — so the search runs once per machine and every later
process reuses the decision with zero re-measurement.

Selection is conservative by construction: the static default config (the
chooser's tile on the probe's backend) is always part of the space, and the
winner must beat it by more than ``noise_margin`` or the default is kept.
On a card every ``"hopper"`` candidate's K1 source is built in one
parallel nvcc run before anything is timed (:func:`candidate_sources`), so
no candidate's time holds a build.  A measured ``"torch"`` winner is a
decision, not a fallback: the tuner never turns a kernel failure into one
(nvcc refusing K1 ends the search).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from ..core.backend import select_backend
from ..core.executor import (compile_plan, env_signature, env_to_torch,
                             host_signature, operand_dtypes, plan_hash,
                             program_hash, resolve_device)
from ..core.ir import Program
from ..core.race import race
from .measure import Measurement, measure_candidate
from .space import (REASSOCIATE_LEVELS, Config, blocks_refusal,
                    candidate_configs)
from .store import (TuningStore, default_store, program_record, record_key,
                    runtime_fence)


@dataclass
class TuningDecision:
    """The tuner's answer for one (program, env signature, runtime)."""

    choice: Config  # the winner (what serving should run)
    default: Config  # the static default it was measured against
    default_us: Optional[float]  # measured static-default time
    tuned_us: Optional[float]  # measured winner time
    search_seconds: float  # wall time of *this* call (0.0 on a store hit)
    from_cache: bool  # True: answered from the persistent store
    key: str  # the program-level store key
    measurements: list = field(default_factory=list)  # [] on a store hit

    @property
    def speedup(self) -> Optional[float]:
        if self.default_us and self.tuned_us:
            return self.default_us / self.tuned_us
        return None

    def as_dict(self) -> dict:
        return dict(choice=self.choice.as_dict(),
                    default=self.default.as_dict(),
                    default_us=self.default_us, tuned_us=self.tuned_us,
                    search_seconds=self.search_seconds,
                    from_cache=self.from_cache, key=self.key,
                    measurements=[m.as_dict() for m in self.measurements])


def _baseline_tolerance(sig: tuple) -> float:
    """The differential harness's per-dtype baseline tolerance for the
    env's floating dtypes (1e-4 for dtypes it has none for)."""
    from ..testing.differential import default_tolerances

    if sig and {dt for _, _, dt in sig} == {"bfloat16"}:  # not in numpy
        return default_tolerances("bfloat16")["baseline"]
    try:
        dts = [np.dtype(dt) for _, _, dt in sig]
        dt = np.result_type(*dts) if dts else np.dtype(np.float32)
        return default_tolerances(dt)["baseline"]
    except (KeyError, TypeError):
        return 1e-4


def _find(measurements: Iterable[Measurement],
          config: Config) -> Optional[Measurement]:
    for m in measurements:
        if m.config == config:
            return m
    return None


def _default_backend_for(plan, backends: Optional[Sequence[str]],
                         sig: tuple) -> str:
    """The static default's backend: the probe's auto choice for the plan
    and the env's dtypes, clamped to the allowed backend set (a
    ``backends=("torch",)`` search must not measure a kernel default just
    because the plan is eligible)."""
    b = select_backend(plan, "auto", operand_dtypes(plan, sig)).backend
    if backends is not None and b not in backends:
        b = "torch" if "torch" in backends else tuple(backends)[0]
    return b


def _prefer_default(winner: Measurement, default_m: Optional[Measurement],
                    default: Config, noise_margin: float) -> Measurement:
    """The conservative tie rule, shared by the program-level pick and the
    per-plan records: a non-default winner must beat the measured default by
    more than ``noise_margin`` or the default is kept."""
    if (default_m is not None and winner.config != default
            and winner.us >= default_m.us * (1.0 - noise_margin)):
        return default_m  # tie / inside noise: keep the static default
    return winner


def _pick(measurements: Sequence[Measurement], default: Config,
          noise_margin: float) -> tuple:
    """(winner Measurement, default Measurement|None) with tie fallback."""
    ok = [m for m in measurements if m.ok]
    if not ok:
        details = "; ".join(
            f"{m.config.describe()}: {m.status} {m.detail}".strip()
            for m in measurements)
        raise RuntimeError(
            f"autotune: no candidate survived the correctness gate "
            f"({details})")
    default_m = _find(ok, default)
    winner = _prefer_default(min(ok, key=lambda m: m.us), default_m,
                             default, noise_margin)
    return winner, default_m


def _opts_token(v):
    """JSON-able view of one search option (non-JSON values — e.g. a cost
    model instance in ``race_opts`` — degrade to their class name)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, Mapping):
        return {str(k): _opts_token(v[k]) for k in sorted(v, key=str)}
    if isinstance(v, (list, tuple, set, frozenset)):
        items = [_opts_token(x) for x in v]
        return sorted(items, key=repr) if isinstance(
            v, (set, frozenset)) else items
    return type(v).__name__


def search_signature(*, levels, backends, grid, quick, default_reassociate,
                     rewrite_div, race_opts, tolerance,
                     noise_margin, batch_sizes=()) -> str:
    """Canonical token of every option that shapes the candidate space or
    the selection rule.  Part of the program-level store key: a decision
    from a narrower search (say ``backends=("torch",)``) must not answer a
    later full-space ``autotune`` call for the same program + env."""
    opts = dict(
        levels=sorted(set(levels)), backends=backends, grid=grid,
        quick=quick, default_reassociate=default_reassociate,
        rewrite_div=rewrite_div, race_opts=dict(race_opts or {}),
        tolerance=tolerance, noise_margin=noise_margin,
    )
    if batch_sizes:
        # only batch-aware searches carry the key: the default token stays
        # that of a per-call search
        opts["batch_sizes"] = sorted(set(int(b) for b in batch_sizes))
    return json.dumps(_opts_token(opts), sort_keys=True,
                      separators=(",", ":"))


def _space(program: Program, sig: tuple, *, levels, backends, grid, quick,
           default_reassociate, rewrite_div, race_opts) -> tuple:
    """``(plans by level, r0 plan, candidate configs, default config)``."""
    opts = dict(race_opts or {})
    opts.pop("tune", None)  # the tuner must not recurse into itself
    opts["rewrite_div"] = rewrite_div
    want_levels = sorted(set(levels) | {default_reassociate})
    results = {lvl: race(program, reassociate=lvl, **opts)
               for lvl in want_levels}
    r0 = results[0] if 0 in results else race(program, reassociate=0,
                                              **opts)
    plans = {lvl: results[lvl].plan for lvl in want_levels}
    configs = candidate_configs(plans, backends=backends, grid=grid,
                                quick=quick, sig=sig)
    default = Config(default_reassociate,
                     _default_backend_for(plans[default_reassociate],
                                          backends, sig))
    if default not in configs:
        configs.append(default)
    return plans, r0.plan, configs, default


def _kernel_sources(plans: Mapping, configs: Sequence[Config],
                    sig: tuple) -> list:
    """K1's source of every ``"hopper"`` candidate the chooser honours."""
    from ..lowering.emit import specialize_stencil

    shapes = {nm: shp for nm, shp, _ in sig}
    dtypes = {nm: dt for nm, _, dt in sig}
    out = []
    for c in configs:
        plan = plans[c.reassociate]
        if c.backend != "hopper" or blocks_refusal(plan, c):
            continue
        try:
            out.append(specialize_stencil(
                plan, shapes, dtypes, c.block_rows, c.block_cols,
                c.block_inner).source)
        except ValueError:  # e.g. hopper-smem: measured as an error
            continue
    return list(dict.fromkeys(out))


def candidate_sources(program: Program, env: Mapping, *,
                      levels: Sequence[int] = REASSOCIATE_LEVELS,
                      backends: Optional[Sequence[str]] = None,
                      grid: Optional[Iterable[tuple]] = None,
                      quick: bool = False, default_reassociate: int = 0,
                      rewrite_div: bool = False,
                      race_opts: Optional[Mapping] = None) -> list:
    """K1's source of every ``"hopper"`` candidate :func:`autotune` would
    measure for ``program`` + ``env`` (same options), for a caller that
    builds many kernels in one :func:`~repro_torch.kernels.build.
    compile_sources` call.  Renders only; builds nothing, on any device."""
    sig = host_signature(env)
    plans, _, configs, _ = _space(
        program, sig, levels=levels, backends=backends,
        grid=list(grid) if grid is not None else None, quick=quick,
        default_reassociate=default_reassociate, rewrite_div=rewrite_div,
        race_opts=race_opts)
    return _kernel_sources(plans, configs, sig)


def autotune(program: Program, env: Mapping, *,
             levels: Sequence[int] = REASSOCIATE_LEVELS,
             backends: Optional[Sequence[str]] = None,
             grid: Optional[Iterable[tuple]] = None, quick: bool = False,
             repeats: int = 5, warmup: int = 2,
             default_reassociate: int = 0, rewrite_div: bool = False,
             race_opts: Optional[Mapping] = None,
             tolerance: Optional[float] = None, noise_margin: float = 0.03,
             store: Optional[TuningStore] = None, force: bool = False,
             write: bool = True, batch_sizes: Sequence[int] = (),
             device=None) -> TuningDecision:
    """Pick (and persist) the fastest correct config for ``program`` + ``env``
    on ``device`` (``None``: ``cuda``, raising without a card; pass
    ``device="cpu"`` to tune the CPU, where ``"hopper"`` is the tile
    emulator).

    Consults the persistent store first: a record for this exact (program
    hash, env signature, runtime fence, search options) answers with zero
    measurement (``from_cache=True``) unless ``force=True`` — the
    search-shaping options (``levels``, ``backends``, ``grid``, ``quick``,
    ``rewrite_div``, ...) are part of the key via :func:`search_signature`,
    so a narrowed search never shadows a full one.  Otherwise the full space
    is measured — ``levels`` x eligible ``backends`` x the block ``grid`` —
    every candidate correctness-gated against the ``reassociate=0``
    ``"torch"`` output at the differential-harness ``tolerance`` for the
    env's dtype, and the winner written back (program-level record plus one
    plan-level record per reassociation level and measured batch size, which
    is what ``compile_plan(..., backend="auto")`` and the serving runtime
    consult).

    The static default — ``default_reassociate`` on the probe's backend with
    the chooser's tile — is always measured too, and wins ties within
    ``noise_margin``.  ``batch_sizes`` (each > 1) re-measures the per-call
    survivors on the batched executor at each size.
    """
    grid = list(grid) if grid is not None else None
    dev = resolve_device(device)
    tenv = env_to_torch(env, dev)
    sig = env_signature(tenv)
    s = store if store is not None else default_store()
    prog_h = program_hash(program)
    fence = runtime_fence(dev)
    batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes if b > 1)))
    search = search_signature(
        levels=levels, backends=backends, grid=grid, quick=quick,
        default_reassociate=default_reassociate, rewrite_div=rewrite_div,
        race_opts=race_opts, tolerance=tolerance, noise_margin=noise_margin,
        batch_sizes=batch_sizes)
    key = record_key("program", prog_h, sig, fence, opts=search)

    from .. import obs

    if not force:
        rec = program_record(prog_h, sig, store=s, opts=search, fence=fence)
        if rec is not None and isinstance(rec.get("choice"), dict):
            stats = rec.get("stats") or {}
            if obs.enabled():
                obs.counter("race_tuning_lookups_total",
                            outcome="store-hit").inc()
                obs.event("tuning_store_hit", program=prog_h,
                          choice=rec["choice"])
            return TuningDecision(
                choice=Config.from_dict(rec["choice"]),
                default=Config.from_dict(rec.get("default", rec["choice"])),
                default_us=stats.get("default_us"),
                tuned_us=stats.get("tuned_us"),
                search_seconds=0.0, from_cache=True, key=key)
    if obs.enabled():
        obs.counter("race_tuning_lookups_total", outcome="search").inc()

    t0 = time.perf_counter()
    plans, plan0, configs, default = _space(
        program, sig, levels=levels, backends=backends, grid=grid,
        quick=quick, default_reassociate=default_reassociate,
        rewrite_div=rewrite_div, race_opts=race_opts)
    truth_ex = compile_plan(plan0, tenv, "torch")
    truth = {k: v.detach() for k, v in truth_ex(tenv).items()}
    tol = tolerance if tolerance is not None else _baseline_tolerance(sig)
    if dev.type == "cuda":  # every candidate's K1 built at once, untimed
        from ..kernels.build import compile_sources

        compile_sources(_kernel_sources(plans, configs, sig))

    with obs.span("autotune", program=prog_h):
        measurements = [
            measure_candidate(plans[c.reassociate], c, tenv, truth, tol,
                              repeats=repeats, warmup=warmup)
            for c in configs]
        winner, default_m = _pick(measurements, default, noise_margin)
        # batch-aware pass: the batched executor has other economics, so
        # the per-call survivors are re-measured at each representative
        # batch size and recorded separately below (what the serving
        # runtime's coalesced dispatch consults)
        if batch_sizes:
            ok_configs = [m.config for m in measurements if m.ok]
            measurements.extend(
                measure_candidate(plans[c.reassociate], c, tenv, truth, tol,
                                  repeats=repeats, warmup=warmup, batch=b)
                for b in batch_sizes for c in ok_configs)
    search_s = time.perf_counter() - t0
    if obs.enabled():
        obs.event("tuning_decision", program=prog_h,
                  choice=winner.config.describe(),
                  default=default.describe(),
                  default_us=default_m.us if default_m else None,
                  tuned_us=winner.us, search_s=search_s,
                  n_candidates=len(measurements),
                  n_ok=sum(m.ok for m in measurements),
                  n_gated=sum(m.status == "gated" for m in measurements),
                  persisted=bool(write))

    if write:
        stamp = dict(device=fence["device"], torch=fence["torch"],
                     cuda=fence["cuda"])
        stats = dict(
            default_us=default_m.us if default_m else None,
            tuned_us=winner.us, search_s=search_s,
            n_candidates=len(measurements),
            n_ok=sum(m.ok for m in measurements),
            n_gated=sum(m.status == "gated" for m in measurements))
        s.put(dict(key=key, kind="program", hash=prog_h, search=search,
                   choice=winner.config.as_dict(),
                   default=default.as_dict(), stats=stats, **stamp))
        for lvl, plan in plans.items():
            level_default = Config(lvl,
                                   _default_backend_for(plan, backends, sig))
            # one plan record per measured batch population: 0 (the per-call
            # path compile_plan consults) plus each tuned batch size (what
            # the serving runtime's coalesced dispatch consults)
            for b in (0,) + batch_sizes:
                level_ms = [m for m in measurements
                            if m.ok and m.config.reassociate == lvl
                            and m.batch == b]
                if not level_ms:
                    continue
                ld_m = _find(level_ms, level_default)
                best = _prefer_default(min(level_ms, key=lambda m: m.us),
                                       ld_m, level_default, noise_margin)
                rec = dict(
                    key=record_key("plan", plan_hash(plan), sig, fence,
                                   batch=b),
                    kind="plan", hash=plan_hash(plan),
                    choice=best.config.as_dict(),
                    stats=dict(us=best.us,
                               default_us=ld_m.us if ld_m else None),
                    **stamp)
                if b:
                    rec["batch"] = b
                s.put(rec)

    return TuningDecision(
        choice=winner.config, default=default,
        default_us=default_m.us if default_m else None, tuned_us=winner.us,
        search_seconds=search_s, from_cache=False, key=key,
        measurements=measurements)
