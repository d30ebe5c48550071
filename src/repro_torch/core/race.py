"""RACE front door of the PyTorch port: detection, contraction, analysis and
execution behind one call (paper Fig. 3 workflow).  Port of
``repro/core/race.py``.

    result = race(program)                      # binary, bitwise-faithful
    result = race(program, reassociate=3)       # n-ary path (Section 7)
    out = result.run(env)                       # on cuda; device="cpu" asks
                                                # for the CPU
    outs = result.run_batch([env0, env1])       # (B, ...) per output
    out = result.run_sharded(env, mesh)         # partitioned over a mesh
    result = race(program, tune=True)           # autotuned on first run
    result = race_from_fn(fn, shapes)           # a plain-Python loop nest
    result.telemetry()                          # hashes, verdicts, obs view

``reassociate`` levels follow Section 7.1 (see the reference module).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import obs as _obs
from . import analysis
from .backend import BACKENDS, Capability, Selection, probe_hopper, select_backend
from .codegen import build_baseline_evaluator, build_plan_evaluator
from .depgraph import Plan, finalize, materialized_elements
from .detect import PaperCost, Transformed, detect_binary
from .ir import Program, fmt_expr, fmt_ref


@dataclass
class RaceResult:
    program: Program
    plan: Plan
    transformed: Transformed
    options: dict
    # per-env-signature tuned delegation: sig -> (TuningDecision, RaceResult)
    _tuned: dict = field(default_factory=dict, repr=False)

    # --- analysis ----------------------------------------------------------
    def profit(self):
        return analysis.profit(self.plan)

    def op_table(self, base: bool = False):
        return analysis.op_table(self.program, None if base else self.plan)

    def reduced_ops(self) -> float:
        return analysis.reduced_ops_fraction(self.program, self.plan)

    def n_aux(self) -> int:
        """Auxiliary arrays *found* (paper Table 1 'AA Num'); contraction may
        inline some of them away (see n_aux_materialized)."""
        return len(self.transformed.aux)

    def n_aux_materialized(self) -> int:
        return len(self.plan.aux_order)

    def rounds(self) -> int:
        return self.plan.rounds

    def materialized_elements(self, contracted: bool = True) -> int:
        return materialized_elements(self.plan, contracted)

    # --- execution ---------------------------------------------------------
    def evaluator(self):
        return build_plan_evaluator(self.plan)

    def baseline_evaluator(self):
        return build_baseline_evaluator(self.program)

    def capability(self) -> Capability:
        """The Hopper kernel's verdict on this plan (no dtypes given)."""
        return probe_hopper(self.plan)

    def select_backend(self, backend: Optional[str] = None) -> Selection:
        """Resolve a backend request (default: the one given to ``race``)."""
        return select_backend(self.plan, backend or self.options["backend"])

    def tune(self, env: dict, *, device=None, **autotune_kw):
        """Measure-and-pick the best (reassociate, backend, blocks) for
        ``env`` on ``device`` (``None``: cuda) via
        :func:`repro_torch.tuning.autotune` (or the persistent store, when
        this machine already tuned this program + signature).

        The decision is remembered on this result: later :meth:`run` /
        :meth:`run_batch` calls with the same env signature and no explicit
        backend execute the winner — including a different reassociation
        level's plan when that measured faster.  Returns the
        :class:`~repro_torch.tuning.TuningDecision`.
        """
        from ..tuning import autotune
        from .executor import host_signature

        opts = self.options
        # rebuild each level with the same plan-shaping knobs as this
        # result, so the plans the tuner measures are the plans run() will
        # execute.  "esr" is deliberately excluded: ESR(+) is a
        # paper-comparison baseline that restricts detection to the
        # innermost level, and forwarding it would make the tuner measure
        # (and persist) those handicapped plans as the winners for the
        # *unrestricted* search
        race_opts = {k: opts[k]
                     for k in ("contraction", "cost_model",
                               "rewrite_sub", "max_rounds",
                               "mis_exact_limit")
                     if k in opts}
        kw = dict(autotune_kw)
        kw.setdefault("default_reassociate", opts.get("reassociate", 0))
        kw.setdefault("rewrite_div", opts.get("rewrite_div", False))
        kw.setdefault("race_opts", race_opts)
        dec = autotune(self.program, env, device=device, **kw)
        ch = dec.choice
        if (ch.reassociate == opts.get("reassociate", 0)
                and not opts.get("esr")):
            target = self
        else:
            # an ESR result always rebuilds, even at its own level: the
            # tuner measured unrestricted plans, so serving must run them
            target = race(self.program, reassociate=ch.reassociate,
                          rewrite_div=opts.get("rewrite_div", False),
                          backend=opts.get("backend"), **race_opts)
        self._tuned[host_signature(env)] = (dec, target)
        return dec

    def _tuned_entry(self, env, sig, device):
        """(decision, target result) for sig, auto-tuning when requested.
        ``env`` may be a zero-arg callable producing the example env, so
        callers can defer materializing it (``run_batch`` slices the
        stacked batch) to the one path that needs concrete values."""
        entry = self._tuned.get(sig)
        if entry is None and self.options.get("tune") is not None:
            if callable(env):
                env = env()
            # race(tune=True) stores {}; race(tune={...}) forwards the
            # kwargs; the run's device is the one tuned
            self.tune(dict(env), **{**self.options["tune"],
                                    "device": device})
            entry = self._tuned.get(sig)
        return entry

    def run(self, env: dict, backend: Optional[str] = None, *, device=None,
            block_rows: int = 0, block_cols: int = 0, block_inner: int = 0):
        """Execute the plan; returns ``{output name: tensor over the
        statement ranges}`` (the interior convention) on ``device``.

        ``device=None`` means ``cuda``, and raises when no GPU is present;
        pass ``device="cpu"`` to run on the CPU, where the ``"hopper"``
        backend runs the kernel's tile emulator.  ``env`` may hold numpy
        arrays, scalars or tensors; they are moved to the device.
        ``block_*`` override the kernel's tile chooser (0 = choose).

        With ``race(..., tune=True)`` (or after an explicit :meth:`tune`),
        calls without an explicit ``backend`` run the tuned winner for the
        env's signature; the first such call pays the search unless the
        persistent store already has the decision.

        With ``race(..., mesh=...)``, a call without an explicit backend
        runs :meth:`run_sharded` on that mesh (whose devices decide where
        it runs, so ``device`` is not read); ``backend=`` opts back into
        the single-device path."""
        from .executor import (compile_plan, env_signature, env_to_torch,
                               resolve_device)

        with _obs.span("entry"):
            if backend is None and self.options.get("mesh") is not None:
                # race(..., mesh=...) makes sharded the default execution
                # path; an explicit backend= on run() opts back into
                # single-device
                return self.run_sharded(
                    env, block_rows=block_rows, block_cols=block_cols,
                    block_inner=block_inner)
            with _obs.span("inputs"):
                dev = resolve_device(device)
                env = env_to_torch(env, dev)
            with _obs.span("lookup"):
                ex = None
                if backend is None and (self._tuned or
                                        self.options.get("tune") is not None):
                    entry = self._tuned_entry(env, env_signature(env), dev)
                    if entry is not None:
                        dec, target = entry
                        ch = dec.choice
                        ex = compile_plan(
                            target.plan, env, ch.backend,
                            block_rows=ch.block_rows,
                            block_cols=ch.block_cols,
                            block_inner=ch.block_inner)
                if ex is None:
                    ex = compile_plan(
                        self.plan, env, backend or self.options["backend"],
                        block_rows=block_rows, block_cols=block_cols,
                        block_inner=block_inner)
            return ex(env)

    def run_sharded(self, env: dict, mesh=None,
                    backend: Optional[str] = None, *,
                    halo: Optional[str] = None, block_rows: int = 0,
                    block_cols: int = 0, block_inner: int = 0):
        """Execute spatially partitioned over a mesh of torch devices.

        The plan's iteration box is split across ``mesh`` (a
        :class:`~repro_torch.launch.mesh.Mesh`, falling back to the
        mesh given to :func:`race`), each shard runs the ordinary compiled
        executor on its chunk on its own device, and halos sized by the
        geometry envelopes travel between neighbours — see
        :mod:`repro_torch.shard`.  ``env`` is moved to the mesh's first
        device, where the outputs come back: the same interior convention
        as :meth:`run`, and gradients flow through an autograd backward
        that re-partitions the adjoint-stencil plans under the same mesh.

        Raises :class:`repro_torch.shard.ShardingUnavailable` with
        structured refusal reasons when no mesh axis can be placed on any
        grid level.  ``halo`` picks the transport strategy (``"auto"`` |
        ``"exchange"`` | ``"recompute"``), defaulting to the one recorded
        by :func:`race`; ``backend`` (default: the one recorded by
        :func:`race`) and ``block_*`` go to every shard's executor."""
        from ..shard import compile_sharded
        from .executor import env_to_torch

        mesh = mesh if mesh is not None else self.options.get("mesh")
        if mesh is None:
            raise ValueError(
                "run_sharded needs a device mesh: pass mesh= here or to "
                "race(..., mesh=...)")
        env = env_to_torch(env, mesh.devices.flat[0])
        ex = compile_sharded(
            self, env, mesh,
            halo=halo if halo is not None
            else self.options.get("halo", "auto"),
            backend=backend or self.options["backend"],
            block_rows=block_rows, block_cols=block_cols,
            block_inner=block_inner)
        return ex(env)

    def run_batch(self, envs, backend: Optional[str] = None, *, device=None,
                  block_rows: int = 0, block_cols: int = 0,
                  block_inner: int = 0):
        """Batched execution: ``envs`` is a sequence of same-signature envs
        or a stacked dict whose every entry carries a leading batch axis
        (scalars as ``(B,)``).  Returns ``{output name: (B, ...) tensor}``
        with ``out[name][b] == run(envs[b])[name]``, on ``device`` as
        :meth:`run` (``None``: cuda, raising without a GPU).  ``run`` and
        ``run_batch`` share one executor: it is keyed on the per-example
        signature.  On ``"hopper"`` the batch is one kernel launch, the
        examples on the grid's second axis.  A tuned decision for the
        per-example signature (see :meth:`tune`) is applied as in
        :meth:`run`."""
        from .executor import (compile_plan, resolve_device, stack_envs,
                               stacked_signature)

        with _obs.span("entry"):
            with _obs.span("inputs"):
                dev = resolve_device(device)
                stacked = stack_envs(envs, dev)
                sig = stacked_signature(stacked)
            with _obs.span("lookup"):
                ex = None
                if backend is None and (self._tuned or
                                        self.options.get("tune") is not None):
                    # the example a tune run needs (batch element 0) is
                    # sliced lazily: only a search reads it
                    entry = self._tuned_entry(
                        lambda: {k: v[0].detach() for k, v in stacked.items()},
                        sig, dev)
                    if entry is not None:
                        dec, target = entry
                        ch = dec.choice
                        ex = compile_plan(
                            target.plan, sig, ch.backend, device=dev,
                            block_rows=ch.block_rows,
                            block_cols=ch.block_cols,
                            block_inner=ch.block_inner)
                if ex is None:
                    ex = compile_plan(
                        self.plan, sig, backend or self.options["backend"],
                        device=dev, block_rows=block_rows,
                        block_cols=block_cols, block_inner=block_inner)
            return ex.run_batch(stacked)

    # --- observability ------------------------------------------------------
    def telemetry(self) -> dict:
        """Everything observable about this result in one dict: structural
        identities (program and plan hashes), the static analysis verdicts
        (reduced-ops fraction, auxiliary counts, the Hopper probe with no
        dtypes given), the process-wide executor-cache stats, and — when
        ``RACE_OBS`` is on — the metrics series, decision events and span
        records carrying this plan's hash.  The reference's keys."""
        from .executor import executor_cache, plan_hash, program_hash

        ph = plan_hash(self.plan)
        cap = self.capability()
        out = dict(
            program=program_hash(self.program),
            plan=ph,
            options={k: v for k, v in self.options.items()
                     if isinstance(v, (bool, int, float, str))},
            reduced_ops=self.reduced_ops(),
            n_aux=self.n_aux(),
            n_aux_materialized=self.n_aux_materialized(),
            rounds=self.rounds(),
            capability=dict(eligible=cap.eligible,
                            reasons=[str(r) for r in cap.reasons],
                            facts=[str(f) for f in cap.facts]),
            executor_cache=executor_cache().cache_info(),
            obs_enabled=_obs.enabled(),
        )
        if _obs.enabled():
            out["metrics"] = _obs.snapshot(label_filter={"plan": ph})
            out["events"] = [e for e in _obs.events()
                             if e.get("plan") == ph]
            # this plan's slice of the span timeline (Chrome-trace ready:
            # repro_torch.obs.trace.chrome_trace renders these records)
            out["spans"] = [s for s in _obs.span_records()
                            if s.get("labels", {}).get("plan") == ph]
        return out

    # --- pretty ------------------------------------------------------------
    def to_source(self) -> str:
        vn = {l.level: l.var for l in self.program.loops}
        lines = []
        for circle_key, names in self.plan.circles:
            rng = dict(circle_key)
            hdr = " ".join(
                f"for {vn.get(l, f'i{l}')} in [{lo},{hi}]"
                for l, (lo, hi) in rng.items())
            lines.append(f"# circle {hdr}")
            for nm in names:
                aux = next(a for a in self.plan.aux_order if a.name == nm)
                lines.append(f"  {fmt_ref(aux.lhs(), vn)} = "
                             f"{fmt_expr(self.plan.aux_exprs[nm], vn)}")
        hdr = " ".join(f"for {l.var} in [{l.lo},{l.hi}]"
                       for l in self.program.loops)
        lines.append(f"# main {hdr}")
        for st in self.plan.body:
            lines.append(f"  {fmt_ref(st.lhs, vn)} = {fmt_expr(st.rhs, vn)}")
        return "\n".join(lines)


def race(
    program: Program,
    reassociate: int = 0,
    esr: bool = False,
    contraction: bool = True,
    cost_model: Optional[object] = None,
    rewrite_sub: bool = True,
    rewrite_div: bool = False,
    max_rounds: int = 64,
    mis_exact_limit: int = 40,
    backend: Optional[str] = None,
    tune=False,
    mesh=None,
    halo: str = "auto",
) -> RaceResult:
    """Run RACE on a program.

    ``backend`` records the request :meth:`RaceResult.run` honors:
    ``"torch"`` (whole-array evaluator), ``"hopper"`` (the CUDA stencil
    kernel; raises ``BackendUnavailable`` when the plan is ineligible) or
    ``"auto"`` (the tuning store's record when there is one, else the kernel
    when the probe passes and the evaluator otherwise, with the reasons in
    the Selection).  ``None`` resolves to ``$RACE_BACKEND`` or ``"auto"``.

    ``tune=True`` defers the strategy/backend/block choice to the autotuner
    (:mod:`repro_torch.tuning`): the first :meth:`RaceResult.run` per env
    signature measures the candidate space on the run's device (or answers
    from the persistent store) and every later call runs the winner.  Pass
    a dict instead of True to forward keyword options to
    :func:`repro_torch.tuning.autotune`, e.g.
    ``tune=dict(levels=(0, 3), backends=("torch",))``.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, e.g. from
    :func:`repro_torch.launch.mesh.make_stencil_mesh`) makes sharded
    execution the default: :meth:`RaceResult.run` delegates to
    :meth:`RaceResult.run_sharded` when no explicit backend is passed.
    ``halo`` records the transport strategy for that path (see
    :data:`repro_torch.shard.HALO_STRATEGIES`)."""
    if backend is None:
        from .executor import default_backend

        backend = default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    with _obs.span("detect", reassociate=str(reassociate)):
        if reassociate:
            from .nary import detect_nary

            transformed = detect_nary(
                program,
                level=reassociate,
                cost_model=cost_model or PaperCost(),
                rewrite_sub=rewrite_sub,
                rewrite_div=rewrite_div,
                max_rounds=max_rounds,
                restrict_innermost=esr,
                mis_exact_limit=mis_exact_limit,
            )
        else:
            transformed = detect_binary(
                program,
                cost_model=cost_model or PaperCost(),
                max_rounds=max_rounds,
                restrict_innermost=esr,
            )
    with _obs.span("contract"):
        plan = finalize(transformed, contraction=contraction)
    if _obs.enabled():
        from .executor import plan_hash, program_hash

        _obs.counter("race_builds_total",
                     reassociate=str(reassociate)).inc()
        _obs.gauge("race_reduced_ops", program=program_hash(program),
                   plan=plan_hash(plan)).set(
            analysis.reduced_ops_fraction(program, plan))
        _obs.gauge("race_aux_materialized", plan=plan_hash(plan)).set(
            len(plan.aux_order))
    return RaceResult(program, plan, transformed, dict(
        reassociate=reassociate, esr=esr, contraction=contraction,
        backend=backend, rewrite_div=rewrite_div,
        # plan-shaping knobs, recorded so RaceResult.tune() measures plans
        # built with *these* options, not the defaults
        cost_model=cost_model, rewrite_sub=rewrite_sub,
        max_rounds=max_rounds, mis_exact_limit=mis_exact_limit,
        tune=(dict(tune) if isinstance(tune, dict)
              else {} if tune else None),
        mesh=mesh, halo=halo))


def race_from_fn(fn, shapes, consts=None, **race_opts) -> RaceResult:
    """Run RACE on a plain-Python loop nest (the capture frontend).

    ``fn`` is an ordinary function written as nested ``for`` loops over
    NumPy-style arrays (or an ``@race_kernel``-wrapped one); ``shapes`` maps
    each parameter to ``()`` (scalar) or an array shape; ``consts`` supplies
    capture-time values for free names.  Remaining keywords go to
    :func:`race`.  Raises ``repro_torch.frontend.CaptureError`` with a
    structured diagnostic when ``fn`` is outside the capturable scope.

        res = race_from_fn(blur, {"u": (64, 64), "out": (64, 64)},
                           reassociate=3)
        out = res.run({"u": u})
    """
    from ..frontend import capture

    return race(capture(fn, shapes, consts), **race_opts)
