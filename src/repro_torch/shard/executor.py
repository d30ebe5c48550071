"""Sharded plan execution: the compiled executor on every shard of a mesh.

Port of ``repro/shard/executor.py``.  :func:`compile_sharded` takes a
:class:`~repro_torch.core.race.RaceResult` plus a mesh of torch devices
(:class:`~repro_torch.launch.mesh.Mesh`), re-ranges the plan's
sharded levels to one chunk, runs RACE on the *local* program with the
global result's own knobs (so the per-shard plan is the same optimization
the single-device path would execute on a chunk-sized grid), and compiles
it through the ordinary plan-keyed executor cache, once per distinct shard
device.  A call (:meth:`ShardedRace.run`) is single-controller, as the
reference's ``shard_map`` is: the halo program
(:mod:`repro_torch.shard.halo`) builds each shard's local env on its
device, each shard's local executor runs there (under
``torch.cuda.device(dev)`` on a card, so every launch has its device
current), and the local interiors are copied into global outputs on the
mesh's first device.  On ``"hopper"`` that is one K1 launch per shard per
call.  No ``torch.distributed``: NCCL takes one rank per card, so the
shards of a one-card mesh (``["cuda:0"] * 4``) could not run at all, gloo
has no point-to-point for CUDA tensors, and a process per shard would
change the contract (a global env in, global outputs out).

Cache identity: sharded entries live in the *same* process-wide
:class:`~repro_torch.core.executor.ExecutorCache` as single-device ones,
but their :class:`~repro_torch.core.executor.ExecutorKey` carries the mesh
axes and devices, the partition spec and the requested halo strategy, so a
sharded compile of a plan hash can never serve (or be served by) its
single-device twin.  The key holds the *requested* backend and halo
strategy — resolution (capability probe, bytes-over-bandwidth heuristic)
happens inside the builder.

Differentiation composes: a call with an input that requires grad goes
through :class:`_ShardedFunction`, whose backward mirrors
:func:`repro_torch.core.adjoint.backward` over the *global* program's
adjoint build, running each input's transposed plan through its own
:func:`compile_sharded` under the same mesh — the adjoint stencil's negated
offsets re-derive the partition with halos flowing the opposite way, no
special-casing.  An adjoint plan the partitioner refuses falls back to the
single-device executor for that input (recorded as a
``shard_adjoint_fallback`` event), and the usual autodiff gates
(``RACE_ADJOINT=autodiff``, build refusal) behave exactly as in the
unsharded path.  The backward is itself differentiable: under
``create_graph`` each adjoint run is again a sharded (or single-device)
autograd node.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from .. import obs as _obs
from ..core.ir import Loop, Program
from .halo import plan_halo, shards_of
from .partition import plan_partition


class ShardingUnavailable(Exception):
    """The partitioner refused this (plan, mesh) pair.

    Carries the full :class:`~repro_torch.shard.partition.PartitionPlan`
    so callers can inspect the structured :class:`ShardRefusal` reasons."""

    def __init__(self, partition):
        self.partition = partition
        self.refusals = partition.refusals
        super().__init__(partition.explain())


class _ShardedFunction(torch.autograd.Function):
    """Autograd node of one sharded call.  ``apply`` tracks positional
    tensors only, so the env comes flattened in ``names`` order and the
    outputs go back as a tuple in ``sr.out_names`` order."""

    @staticmethod
    def forward(ctx, sr, names, *tensors):
        ctx.sr, ctx.names = sr, names
        ctx.save_for_backward(*tensors)
        outs = sr._forward(dict(zip(names, tensors)))
        return tuple(outs[nm] for nm in sr.out_names)

    @staticmethod
    def backward(ctx, *gouts):
        sr, names = ctx.sr, ctx.names
        wrt = [nm for nm, need in zip(names, ctx.needs_input_grad[2:])
               if need]
        grads = sr._backward(dict(zip(names, ctx.saved_tensors)),
                             dict(zip(sr.out_names, gouts)), wrt)
        return (None, None) + tuple(grads[nm] for nm in names)


class ShardedRace:
    """One sharded specialization: the local executor on every shard.

    Mirrors :class:`~repro_torch.core.executor.CompiledRace`'s contract —
    callable on any same-signature tensor env, interior-convention outputs
    — with the iteration box spatially partitioned over ``mesh`` per
    ``partition`` and halos transported per ``halo_prog``.  ``locals`` maps
    each distinct shard device to its local executor; ``local`` is the
    first shard's.  ``kernel_launches`` sums their K1 launches."""

    def __init__(self, result, mesh, partition, halo_prog, locals_, *,
                 halo: str, cache):
        from ..core.executor import plan_hash

        self.result = result
        self.mesh = mesh
        self.partition = partition
        self.halo_prog = halo_prog
        self.shards = shards_of(mesh)
        self.locals = locals_
        self.local = locals_[str(self.shards[0][1])]
        self.backend = self.local.backend
        self.device = self.shards[0][1]
        self.out_names = tuple(halo_prog.out_axes)
        self.calls = 0
        self._plan_h = plan_hash(result.plan)
        self._halo = halo  # the requested strategy, for the adjoints
        self._cache = cache
        self._adj_memo: dict = {}

    @property
    def kernel_launches(self) -> int:
        return sum(ex.kernel_launches for ex in self.locals.values())

    # -- forward ------------------------------------------------------------

    def _forward(self, env: Mapping) -> dict:
        """Local envs, each shard's local core on its device, global
        outputs on the mesh's first device."""
        envs = self.halo_prog.local_envs(env, self.shards)
        outs = []
        for local_env, (_, dev) in zip(envs, self.shards):
            core = self.locals[str(dev)].core_fn
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    outs.append(core(local_env))
            else:
                outs.append(core(local_env))
        return self.halo_prog.assemble(outs, self.shards, self.device)

    def _call(self, env: Mapping) -> dict:
        if torch.is_grad_enabled() and any(v.requires_grad
                                           for v in env.values()):
            names = tuple(sorted(env))
            outs = _ShardedFunction.apply(self, names,
                                          *(env[nm] for nm in names))
            return dict(zip(self.out_names, outs))
        return self._forward(env)

    def run(self, env: Mapping) -> dict:
        """Execute sharded on a tensor env; returns the same
        interior-convention outputs as the single-device ``run``, on the
        mesh's first device."""
        self.calls += 1
        if not _obs.enabled():
            return self._call(env)
        phase = "compile" if self.calls == 1 else "run"
        with _obs.span(phase, plan=self._plan_h, backend=self.backend,
                       sharded="1"):
            out = self._call(env)
        hp = self.halo_prog
        _obs.counter("race_shard_runs_total", plan=self._plan_h,
                     strategy=hp.strategy).inc()
        if hp.strategy == "exchange":
            _obs.counter("race_shard_halo_bytes_total",
                         plan=self._plan_h).inc(float(hp.halo_bytes))
        else:
            _obs.counter("race_shard_restack_bytes_total",
                         plan=self._plan_h).inc(float(hp.restack_bytes))
        return out

    __call__ = run

    # -- backward -------------------------------------------------------------

    def _adjoint_executor(self, spec, adj_env):
        """Sharded executor for one input's adjoint plan, memoized per
        (input, adjoint signature); single-device fallback on refusal.
        The adjoint plans run as the unsharded backward runs them: on
        ``$RACE_BACKEND`` or ``"auto"``, at K1's chosen tile."""
        from ..core.executor import compile_plan, env_signature

        sig = env_signature(adj_env)
        key = (spec.input, sig)
        ex = self._adj_memo.get(key)
        if ex is None:
            res = spec.result()
            try:
                ex = compile_sharded(res, sig, self.mesh, halo=self._halo,
                                     cache=self._cache)
            except ShardingUnavailable as err:
                if _obs.enabled():
                    _obs.event("shard_adjoint_fallback", plan=self._plan_h,
                               input=spec.input,
                               reasons=[str(r) for r in err.refusals])
                ex = compile_plan(res.plan, sig, device=self.device,
                                  cache=self._cache)
            self._adj_memo[key] = ex
        return ex

    def _backward(self, env: Mapping, g: Mapping, wrt) -> dict:
        """Mirror of :func:`repro_torch.core.adjoint.backward` with each
        adjoint plan running under this executor's own mesh partition.
        Returns its full-env result, as
        :func:`~repro_torch.core.adjoint.complete_gradients` gives it."""
        from ..core import adjoint as adj

        program = self.result.program
        if adj.adjoint_mode() == "autodiff" or not adj.adjoint_build(
                program).ok:
            if _obs.enabled():
                _obs.counter("race_adjoint_backward_total",
                             mode="autodiff-sharded").inc()
            return adj.complete_gradients(
                program, env, adj._autodiff_backward(program, env, g, wrt),
                wrt)
        build = adj.adjoint_build(program)
        grads = {}
        with _obs.span("adjoint_backward", sharded="1"):
            for spec in build.specs:
                if spec.input not in wrt:
                    continue
                adj_env = adj.assemble_adjoint_env(spec, env, g)
                ex = self._adjoint_executor(spec, adj_env)
                val = ex(adj_env)[spec.gu]
                grads[spec.input] = adj.finalize_adjoint(spec, env, val)
        if _obs.enabled():
            _obs.counter("race_adjoint_backward_total",
                         mode="stencil-sharded").inc()
        return adj.complete_gradients(program, env, grads, wrt)

    def adjoint_executors(self) -> dict:
        """``{input: executor}`` of the adjoint plans built so far: a
        :class:`ShardedRace` where the partitioner admitted the adjoint
        program, the single-device executor where it refused."""
        return {inp: ex for (inp, _), ex in self._adj_memo.items()}

    # -- introspection ------------------------------------------------------

    def cache_info(self) -> dict:
        hp = self.halo_prog
        return dict(backend=self.backend, calls=self.calls,
                    strategy=hp.strategy, halo_bytes=hp.halo_bytes,
                    restack_bytes=hp.restack_bytes,
                    slab_bytes=hp.slab_bytes,
                    partition=self.partition.key(),
                    mesh=self.partition.mesh_axes,
                    kernel_launches=self.kernel_launches,
                    local=self.local.cache_info())

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"<ShardedRace {self.backend} plan={self._plan_h} "
                f"partition={self.partition.key()} "
                f"strategy={self.halo_prog.strategy} calls={self.calls}>")


def _local_program(program: Program, partition) -> Program:
    """The global program with each assigned level re-ranged to one chunk."""
    chunks = {a.level: a.chunk for a in partition.assignments}
    loops = tuple(
        Loop(lp.level, lp.var, lp.lo, lp.lo + chunks[lp.level] - 1)
        if lp.level in chunks else lp
        for lp in program.loops)
    return Program(loops, program.body, program.loc)


#: RaceResult.options knobs forwarded to the local (per-chunk) RACE build,
#: so the per-shard plan is shaped exactly like the global one.  "tune" is
#: deliberately excluded: the local build must be deterministic — the sharded
#: executor is keyed on the *global* plan hash, and a tuner swapping the
#: local plan underneath would break that identity.
_LOCAL_RACE_KNOBS = ("reassociate", "esr", "contraction", "cost_model",
                     "rewrite_sub", "rewrite_div", "max_rounds",
                     "mis_exact_limit")


def compile_sharded(result, env: Union[Mapping, tuple], mesh, *,
                    halo: str = "auto", backend: Optional[str] = None,
                    block_rows: int = 0, block_cols: int = 0,
                    block_inner: int = 0, cache=None) -> ShardedRace:
    """Fetch (or build) the sharded executor for (result, env, mesh).

    Raises :class:`ShardingUnavailable` — carrying every structured
    :class:`~repro_torch.shard.partition.ShardRefusal` — when no mesh axis
    can be placed on any grid level; never falls back silently.  ``env`` is
    a tensor environment or a precomputed ``env_signature``.  ``halo`` is
    one of :data:`~repro_torch.shard.halo.HALO_STRATEGIES` (``"auto"``
    resolves by the roofline heuristic).  ``backend`` (None:
    ``$RACE_BACKEND`` or ``"auto"``) and ``block_*`` go to every shard's
    local executor.  The entry lives in the process-wide executor cache
    under a mesh/partition/halo-qualified key."""
    from ..core.executor import (ExecutorKey, compile_plan, default_backend,
                                 env_signature, executor_cache, plan_hash)
    from ..core.race import race

    sig = env if isinstance(env, tuple) else env_signature(env)
    ph = plan_hash(result.plan)
    partition = plan_partition(result.program, mesh)
    if not partition.ok:
        if _obs.enabled():
            for r in partition.refusals:
                _obs.counter("race_shard_refusals_total", code=r.code).inc()
            _obs.event("shard_refusal", plan=ph,
                       mesh=str(partition.mesh_axes),
                       reasons=[str(r) for r in partition.refusals])
        raise ShardingUnavailable(partition)

    c = cache if cache is not None else executor_cache()
    backend = backend or default_backend()
    shards = shards_of(mesh)
    key = ExecutorKey(
        ph, sig, backend, (block_rows, block_cols, block_inner),
        str(shards[0][1]), mesh=mesh.key(), partition=partition.key(),
        halo=halo)

    def _build() -> ShardedRace:
        with _obs.span("shard_plan", plan=ph):
            local_prog = _local_program(result.program, partition)
            race_kw = {k: result.options[k] for k in _LOCAL_RACE_KNOBS
                       if k in result.options}
            local_res = race(local_prog,
                             backend=result.options.get("backend"),
                             **race_kw)
            with _obs.span("halo_exchange", plan=ph):
                hp = plan_halo(partition, local_res.plan, sig, strategy=halo)
            local_sig = tuple((nm, tuple(hp.specs[nm].local_shape), dt)
                              for nm, _shape, dt in sig)
            locals_ = {}
            for _, dev in shards:
                if str(dev) not in locals_:
                    locals_[str(dev)] = compile_plan(
                        local_res.plan, local_sig, backend, device=dev,
                        block_rows=block_rows, block_cols=block_cols,
                        block_inner=block_inner, cache=c)
        local = locals_[str(shards[0][1])]
        if _obs.enabled():
            _obs.event("shard_plan", plan=ph,
                       local_plan=plan_hash(local_res.plan),
                       mesh=str(partition.mesh_axes),
                       partition=str(partition.key()),
                       strategy=hp.strategy, halo_bytes=hp.halo_bytes,
                       restack_bytes=hp.restack_bytes,
                       backend=local.backend,
                       refusals=[str(r) for r in partition.refusals])
        return ShardedRace(result, mesh, partition, hp, locals_, halo=halo,
                           cache=c)

    return c.get_or_build(key, _build)
