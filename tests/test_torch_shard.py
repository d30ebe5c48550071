"""Sharded giant-grid execution on the port (``repro_torch.shard``) against
the reference's ``repro.shard``.

The cases of ``tests/test_shard.py`` on the port's own copy (mesh
factoring, one negative fixture per refusal code, halo accounting, cache
identity, unit-mesh equality, ``race(mesh=)`` routing, the unit-mesh
gradient, the obs spans, events and counters), then parity: on the
reference's registry sweep (15 sharded and 4 refused cases, at its sizes)
the partition keys and refusal codes, the halo specs and byte counts equal
the reference's, and ``run_sharded`` on a 4-shard 2x2 mesh of CPU devices
(``devices=["cpu"] * 4``, the counterpart of the reference's forced host
devices) equals the reference's single-device ``"xla"`` ``run`` — at
float64 within ``1e-10 x scale`` (the reference's own bound), at float32
within ``plan`` — on ``"torch"`` and on ``"hopper"`` (its tile emulator
here), for both halo strategies.  Gradients through ``run_sharded`` equal
``jax.grad`` of the reference at float64 ``grad``, each adjoint spec's
sharded-or-fallback decision is the reference partitioner's, and second
order never returns ``None``.

The port's ``"auto"`` halo pick weighs NVLink against HBM on the H100
(``repro_torch.launch.mesh``), not ICI against HBM on a v5e: where the two
picks differ, the port's is pinned here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.apps.paper_kernels import get_case as ref_case
from repro.core.adjoint import adjoint_build as ref_adjoint_build
from repro.core.executor import env_signature as ref_env_signature
from repro.core.race import race as ref_race
from repro.shard import plan_halo as ref_plan_halo
from repro.shard import plan_partition as ref_plan_partition
from repro.shard.executor import _local_program as ref_local_program
from repro.testing.differential import _x64_ctx

from repro_torch import obs
from repro_torch.apps import get_case
from repro_torch.core.executor import (ExecutorCache, ExecutorKey,
                                       compile_plan, env_signature,
                                       executor_cache)
from repro_torch.core.ir import arr, loopnest, program
from repro_torch.core.race import race
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_stencil_mesh, stencil_mesh_shape
from repro_torch.shard import (HALO_STRATEGIES, S_DIVISIBILITY, S_ENVELOPE,
                               S_GATHER, S_GEOMETRY, S_HALO, S_MIRRORED,
                               S_NO_AXIS, S_STRIDED, SHARD_REFUSAL_CODES,
                               ShardedRace, ShardingUnavailable,
                               compile_sharded, plan_halo, plan_partition)
from repro_torch.shard.executor import _local_program
from repro_torch.shard.halo import shards_of
from repro_torch.testing import (build_env, default_tolerances, env_to_torch,
                                 rel_err)

pytestmark = [pytest.mark.port, pytest.mark.shard]

CPU = "cpu"

#: the reference's multi-device sweep (``tests/test_shard.py``): every
#: registry case at a mesh-divisible size, and the refused ones with codes
SWEEP = [("poisson", 10), ("j3d27pt", 10), ("diffusion1", 10),
         ("diffusion2", 10), ("diffusion3", 10), ("psinv", 10),
         ("resid", 10), ("rhs_ph1", 10), ("rhs_ph2", 10),
         ("smooth1d", 24), ("hdifft_gm", 14), ("ocn_export", 14),
         ("mirror_deriv", 14), ("diag2d", 14), ("blocked4d", 6)]
REFUSED = [("gaussian", 21, S_DIVISIBILITY),
           ("calc_tpoints", 12, S_DIVISIBILITY),
           ("derivative", 11, S_DIVISIBILITY),
           ("rprj3", 12, S_STRIDED)]


class FakeMesh:
    """Duck-typed mesh for partition-only tests: ``plan_partition`` reads
    just ``axis_names`` + ``shape`` and never touches devices (the same
    object serves both packages' partitioners)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


@pytest.fixture(autouse=True)
def _isolated_port_obs(monkeypatch):
    for knob in (obs.ENV_OBS, obs.ENV_EVENTS, obs.ENV_RING, obs.ENV_SPANS):
        monkeypatch.delenv(knob, raising=False)
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(autouse=True)
def _fresh_executor_cache():
    """Sharded entries stay out of the process-wide cache that other test
    files read (they expect single-device executors there)."""
    executor_cache().clear()
    yield
    executor_cache().clear()


def _codes(part):
    return {r.code for r in part.refusals}


def _unit_mesh():
    return make_stencil_mesh(1, ("sx", "sy"), devices=[CPU])


def _mesh4():
    return make_stencil_mesh(4, ("sx", "sy"), devices=[CPU] * 4)


def _tenv(case, dtype=np.float32, seed=0):
    return env_to_torch(build_env(case, dtype, seed=seed), CPU)


# ---------------------------------------------------------------------------
# mesh factoring
# ---------------------------------------------------------------------------


def test_stencil_mesh_shape_near_square():
    assert stencil_mesh_shape(1, 2) == (1, 1)
    assert stencil_mesh_shape(2, 2) == (2, 1)
    assert stencil_mesh_shape(4, 2) == (2, 2)
    assert stencil_mesh_shape(6, 2) == (3, 2)
    assert stencil_mesh_shape(8, 2) == (4, 2)
    for n in range(1, 33):
        shape = stencil_mesh_shape(n, 2)
        assert shape[0] * shape[1] == n  # exact coverage, no devices dropped
        assert shape[0] >= shape[1]


def test_make_stencil_mesh_single_device():
    mesh = _unit_mesh()
    assert mesh.axis_names == ("sx", "sy")
    assert dict(mesh.shape) == {"sx": 1, "sy": 1}
    assert mesh.devices.shape == (1, 1)
    assert mesh.devices[0, 0] == torch.device(CPU)


def test_make_stencil_mesh_repeats_a_device_and_counts_cuda():
    mesh = _mesh4()
    assert dict(mesh.shape) == {"sx": 2, "sy": 2}
    assert [str(d) for d in mesh.devices.flat] == [CPU] * 4
    assert mesh.key() == ((("sx", 2), ("sy", 2)), (CPU,) * 4)
    assert make_stencil_mesh(devices=[CPU] * 6).devices.shape == (3, 2)
    with pytest.raises(ValueError, match="out of range"):
        make_stencil_mesh(5, devices=[CPU] * 4)
    # the default takes CUDA devices, as the reference takes jax.devices():
    # one more than there are raises (with no card, any count does)
    with pytest.raises(ValueError, match="visible CUDA"):
        make_stencil_mesh(torch.cuda.device_count() + 1)


def test_mesh_constants_are_the_h100s():
    assert mesh_mod.HBM_BW == 3.35e12
    assert mesh_mod.LINK_BW == 450e9


# ---------------------------------------------------------------------------
# partitioner: positive placement
# ---------------------------------------------------------------------------


def test_partition_poisson_placement():
    case = get_case("poisson", 10)
    res = race(case.program, reassociate=case.reassociate)
    part = plan_partition(res.program, FakeMesh(sx=4, sy=2))
    assert part.ok
    assert part.key() == ((1, "sx", 4), (2, "sy", 2))
    a = part.by_level[1]
    assert (a.extent, a.chunk, a.halo) == (8, 2, 2)  # E=8, e=8/4, t=lo+off_hi
    assert "sharded" in part.explain()


def test_partition_single_axis_leftover_is_ok():
    # mirror_deriv: level 1 is mirrored, only level 2 shardable; the second
    # mesh axis finds no level but the plan still shards
    case = get_case("mirror_deriv", 14)
    part = plan_partition(case.program, FakeMesh(sx=2, sy=2))
    assert part.ok
    assert part.key() == ((2, "sx", 2),)
    assert S_MIRRORED in _codes(part)


def test_refusal_codes_are_pinned_vocabulary():
    for nm, n in [("mirror_deriv", 14), ("rprj3", 12), ("diag2d", 14),
                  ("gaussian", 21)]:
        part = plan_partition(get_case(nm, n).program, FakeMesh(sx=2))
        assert _codes(part) <= SHARD_REFUSAL_CODES


# ---------------------------------------------------------------------------
# partitioner: one negative fixture per refusal code
# ---------------------------------------------------------------------------


def test_refusal_mirrored():
    part = plan_partition(get_case("mirror_deriv", 14).program,
                          FakeMesh(sx=2))
    refs = [r for r in part.refusals if r.code == S_MIRRORED]
    assert refs and refs[0].level == 1


def test_refusal_strided_and_no_axis():
    part = plan_partition(get_case("rprj3", 12).program, FakeMesh(sx=2))
    assert not part.ok
    assert S_STRIDED in _codes(part)
    assert S_NO_AXIS in _codes(part)


def test_refusal_gather():
    part = plan_partition(get_case("diag2d", 14).program, FakeMesh(sx=2))
    assert [r for r in part.refusals if r.code == S_GATHER]


def test_refusal_divisibility():
    part = plan_partition(get_case("poisson", 10).program, FakeMesh(sx=3))
    assert not part.ok
    assert S_DIVISIBILITY in _codes(part)
    assert S_NO_AXIS in _codes(part)


def test_refusal_halo_exceeds_chunk():
    part = plan_partition(get_case("poisson", 10).program, FakeMesh(sx=8))
    assert not part.ok
    assert S_HALO in _codes(part)


def test_refusal_envelope():
    u, y = arr("u"), arr("y")
    loops, (i,) = loopnest(("i", 1, 6))
    prog = program(loops, [(y[i], u[i - 2] + u[i])])
    part = plan_partition(prog, FakeMesh(sx=2))
    assert not part.ok
    assert S_ENVELOPE in _codes(part)


def test_refusal_geometry():
    u, y = arr("u"), arr("y")
    loops, (i,) = loopnest(("i", 1, 4))
    prog = program(loops, [(y[i], u[i] + u[2 * i])])
    part = plan_partition(prog, FakeMesh(sx=2))
    assert not part.ok
    assert _codes(part) == {S_GEOMETRY}
    assert part.verdicts == ()


def test_compile_sharded_raises_structured():
    case = get_case("rprj3", 12)
    res = race(case.program, reassociate=case.reassociate)
    with pytest.raises(ShardingUnavailable) as ei:
        compile_sharded(res, _tenv(case), _mesh4(), cache=ExecutorCache(8))
    assert any(r.code == S_STRIDED for r in ei.value.refusals)
    assert S_STRIDED in str(ei.value)


# ---------------------------------------------------------------------------
# halo program accounting
# ---------------------------------------------------------------------------


def test_halo_accounting_and_forced_strategy():
    case = get_case("poisson", 10)
    res = race(case.program, reassociate=case.reassociate)
    part = plan_partition(res.program, FakeMesh(sx=2, sy=2))
    assert part.ok
    local = race(_local_program(res.program, part),
                 reassociate=case.reassociate)
    sig = env_signature(_tenv(case))
    hx = plan_halo(part, local.plan, sig, strategy="exchange")
    hr = plan_halo(part, local.plan, sig, strategy="recompute")
    ha = plan_halo(part, local.plan, sig, strategy="auto")
    assert hx.strategy == "exchange" and hr.strategy == "recompute"
    assert ha.strategy in ("exchange", "recompute")
    assert 0 < hx.halo_bytes < hr.restack_bytes
    u = hx.specs["u"]
    assert u.mode == "slab"
    for sd in u.slabs:
        assert u.local_shape[sd.dim] == sd.chunk + sd.halo
    # the prologue writes every shard's contiguous slab once
    slabs = [s for s in hx.specs.values() if s.mode == "slab"]
    assert hx.slab_bytes == sum(
        4 * 4 * int(np.prod(s.local_shape)) for s in slabs)
    with pytest.raises(ValueError):
        plan_halo(part, local.plan, sig, strategy="teleport")
    assert set(HALO_STRATEGIES) == {"auto", "exchange", "recompute"}


def test_auto_pick_uses_the_h100_constants():
    """poisson n=10 f32 on 2x2: 3,032 halo bytes against 27,664 restack
    bytes (0.110).  On the H100 (450 GB/s NVLink, 3.35 TB/s HBM: break-even
    0.134) the port exchanges; the reference, on v5e constants (50 GB/s
    ICI, 819 GB/s HBM: break-even 0.061), recomputes."""
    case, rc = get_case("poisson", 10), ref_case("poisson", 10)
    part = plan_partition(case.program, FakeMesh(sx=2, sy=2))
    local = race(_local_program(case.program, part),
                 reassociate=case.reassociate)
    env = build_env(case, np.float32, seed=0)
    port = plan_halo(part, local.plan, env_signature(env_to_torch(env, CPU)))
    rpart = ref_plan_partition(rc.program, FakeMesh(sx=2, sy=2))
    rlocal = ref_race(ref_local_program(rc.program, rpart),
                      reassociate=rc.reassociate)
    ref = ref_plan_halo(rpart, rlocal.plan, ref_env_signature(env))
    assert (port.halo_bytes, port.restack_bytes) == (3032, 27664)
    assert (ref.halo_bytes, ref.restack_bytes) == (3032, 27664)
    assert port.strategy == "exchange"
    assert ref.strategy == "recompute"


@pytest.mark.parametrize("strategy", ["exchange", "recompute"])
@pytest.mark.parametrize("name,n", [("poisson", 10), ("blocked4d", 6),
                                    ("hdifft_gm", 14)])
def test_local_slabs_are_the_global_boxes(name, n, strategy):
    """Each shard's local slab is exactly the global array over its box
    (edges and corners included), contiguous, on its device."""
    case = get_case(name, n)
    res = race(case.program, reassociate=case.reassociate)
    mesh = _mesh4()
    part = plan_partition(res.program, mesh)
    local = race(_local_program(res.program, part),
                 reassociate=case.reassociate)
    env = _tenv(case, np.float64, seed=4)
    hp = plan_halo(part, local.plan, env_signature(env), strategy=strategy)
    shards = shards_of(mesh)
    envs = hp.local_envs(env, shards)
    for le, (coords, _) in zip(envs, shards):
        for nm, spec in hp.specs.items():
            assert tuple(le[nm].shape) == tuple(spec.local_shape)
            assert le[nm].is_contiguous()
            if spec.mode == "slab":
                want = env[nm][hp.slab_box(spec, coords)]
                assert torch.equal(le[nm], want), (nm, coords)


# ---------------------------------------------------------------------------
# cache identity
# ---------------------------------------------------------------------------


def test_sharded_cache_key_never_collides():
    case = get_case("poisson", 10)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div, backend="torch")
    env = _tenv(case, seed=1)
    mesh = _unit_mesh()
    c = ExecutorCache(16)
    single = compile_plan(res.plan, env, "torch", cache=c)
    sharded = compile_sharded(res, env, mesh, backend="torch", cache=c)
    assert sharded is not single
    # on a size-1 mesh the local program equals the global one, so the
    # sharded build's inner compile_plan HITS the single-device entry:
    # exactly two entries, one of them mesh-keyed
    info = c.cache_info()
    assert info["currsize"] == 2
    assert info["sharded"] == 1
    assert info["devices"] == [CPU]
    assert sharded.local is single
    assert compile_sharded(res, env, mesh, backend="torch", cache=c) is sharded
    other = compile_sharded(res, env, mesh, backend="torch",
                            halo="recompute", cache=c)
    assert other is not sharded
    assert c.cache_info()["sharded"] == 2
    ci = sharded.cache_info()
    assert ci["strategy"] in ("exchange", "recompute")
    assert ci["partition"] == sharded.partition.key()
    # single-device keys keep the defaults; sharded keys carry the mesh
    keys = c.keys()
    assert sum(k.mesh is None and k.partition is None and k.halo is None
               for k in keys) == 1
    assert ExecutorKey("p", (), "torch", None, CPU).mesh is None


# ---------------------------------------------------------------------------
# differential: size-1 mesh (full machinery, bitwise equality)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("name,n", [("poisson", 10), ("smooth1d", 24),
                                    ("blocked4d", 6)])
@pytest.mark.parametrize("strategy", ["exchange", "recompute"])
def test_sharded_matches_single_device_on_unit_mesh(name, n, strategy,
                                                    backend):
    case = get_case(name, n)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div, backend=backend)
    env = build_env(case, np.float32, seed=3)
    base = res.run(env, device=CPU)
    got = res.run_sharded(dict(env), _unit_mesh(), halo=strategy)
    assert set(got) == set(base)
    for k in base:
        # the size-1 local program IS the global program: same plan, same
        # executor core, so the sharding must be exactly neutral
        assert torch.equal(got[k], base[k]), k


def test_race_mesh_option_routes_run():
    case = get_case("poisson", 10)
    env = build_env(case, np.float32, seed=5)
    mesh = _unit_mesh()
    obs.configure(enabled=True)
    res = race(case.program, reassociate=case.reassociate, mesh=mesh)
    base = race(case.program, reassociate=case.reassociate).run(
        env, device=CPU)
    got = res.run(dict(env))  # no explicit backend: delegates to sharded
    for k in base:
        assert torch.equal(got[k], base[k]), k
    counters = obs.dump()["metrics"]["counters"]
    assert any(k.startswith("race_shard_runs_total") for k in counters)
    # explicit backend= opts back into the single-device path
    before = sum(v for k, v in counters.items()
                 if k.startswith("race_shard_runs_total"))
    res.run(dict(env), "torch", device=CPU)
    counters = obs.dump()["metrics"]["counters"]
    after = sum(v for k, v in counters.items()
                if k.startswith("race_shard_runs_total"))
    assert after == before
    with pytest.raises(ValueError, match="mesh"):
        race(case.program).run_sharded(env)


def test_gradient_through_run_sharded_unit_mesh():
    case = get_case("poisson", 8)
    env = build_env(case, np.float32, seed=7)
    res = race(case.program, reassociate=case.reassociate, backend="torch")
    mesh = _unit_mesh()
    key = sorted(res.run(env, device=CPU))[0]

    def grad(run):
        u = torch.tensor(env["u"], requires_grad=True)
        out = run({**env, "u": u})[key]
        return torch.autograd.grad(out.sum(), u)[0]

    g1 = grad(lambda e: res.run(e, device=CPU))
    g2 = grad(lambda e: res.run_sharded(e, mesh))
    assert torch.allclose(g1, g2, rtol=1e-6, atol=1e-6)


def test_shard_refusal_event_and_counter():
    obs.configure(enabled=True)
    case = get_case("rprj3", 12)
    res = race(case.program, reassociate=case.reassociate)
    with pytest.raises(ShardingUnavailable):
        compile_sharded(res, _tenv(case), _mesh4(), cache=ExecutorCache(8))
    evs = obs.events("shard_refusal")
    assert evs and any(S_STRIDED in r for r in evs[-1]["reasons"])
    counters = obs.dump()["metrics"]["counters"]
    assert any(k.startswith("race_shard_refusals_total") for k in counters)


def test_shard_plan_span_and_event():
    obs.configure(enabled=True)
    case = get_case("poisson", 10)
    res = race(case.program, reassociate=case.reassociate, backend="torch")
    env = build_env(case, np.float32, seed=2)
    res.run_sharded(dict(env), _unit_mesh())
    res.run_sharded(dict(env), _unit_mesh())
    spans = obs.span_summary()
    assert spans.get("shard_plan", {}).get("count", 0) >= 1
    assert spans.get("halo_exchange", {}).get("count", 0) >= 1
    recs = [s for s in obs.span_records()
            if s.get("labels", {}).get("sharded") == "1"]
    assert {s["name"] for s in recs} >= {"compile", "run"}
    evs = obs.events("shard_plan")
    assert evs
    ev = evs[-1]
    assert ev["strategy"] in ("exchange", "recompute")
    assert ev["partition"] and ev["local_plan"]
    counters = obs.dump()["metrics"]["counters"]
    assert any(k.startswith("race_shard_halo_bytes_total")
               or k.startswith("race_shard_restack_bytes_total")
               for k in counters)


# ---------------------------------------------------------------------------
# parity with the reference on its registry sweep (4-shard 2x2 CPU mesh)
# ---------------------------------------------------------------------------


def _ref_partition(name, n):
    return ref_plan_partition(ref_case(name, n).program, FakeMesh(sx=2, sy=2))


@pytest.mark.parametrize("name,n", SWEEP + [(nm, n) for nm, n, _ in REFUSED])
def test_partition_parity_with_reference(name, n):
    part = plan_partition(get_case(name, n).program, FakeMesh(sx=2, sy=2))
    ref = _ref_partition(name, n)
    assert part.ok == ref.ok
    assert part.key() == ref.key()
    assert [(r.code, r.level) for r in part.refusals] == [
        (r.code, r.level) for r in ref.refusals]
    assert [dataclasses.astuple(a) for a in part.assignments] == [
        dataclasses.astuple(a) for a in ref.assignments]


def _spec_tuple(s):
    return (s.name, s.mode, tuple(s.shape), s.dtype,
            tuple(dataclasses.astuple(sd) for sd in s.slabs),
            tuple(s.local_shape))


@pytest.mark.parametrize("name,n", SWEEP)
def test_halo_program_parity_with_reference(name, n):
    case, rc = get_case(name, n), ref_case(name, n)
    env = build_env(case, np.float64, seed=11)
    part = plan_partition(case.program, FakeMesh(sx=2, sy=2))
    rpart = _ref_partition(name, n)
    local = race(_local_program(case.program, part),
                 reassociate=case.reassociate, rewrite_div=case.rewrite_div)
    with _x64_ctx(np.float64):
        rlocal = ref_race(ref_local_program(rc.program, rpart),
                          reassociate=rc.reassociate,
                          rewrite_div=rc.rewrite_div)
        rsig = ref_env_signature({k: jnp.asarray(v) for k, v in env.items()})
        for strategy in ("exchange", "recompute"):
            hp = plan_halo(part, local.plan,
                           env_signature(env_to_torch(env, CPU)), strategy)
            ref = ref_plan_halo(rpart, rlocal.plan, rsig, strategy)
            assert hp.strategy == ref.strategy == strategy
            assert hp.halo_bytes == ref.halo_bytes
            assert hp.restack_bytes == ref.restack_bytes
            assert {k: _spec_tuple(s) for k, s in hp.specs.items()} == {
                k: _spec_tuple(s) for k, s in ref.specs.items()}
            assert hp.out_local_extent == ref.out_local_extent


def _ref_run(rc, env, dtype):
    with _x64_ctx(dtype):
        res = ref_race(rc.program, reassociate=rc.reassociate,
                       rewrite_div=rc.rewrite_div, backend="xla")
        return {k: np.asarray(v) for k, v in res.run(env, "xla").items()}


@pytest.mark.parametrize("name,n", SWEEP)
def test_registry_sharded_matches_reference(name, n):
    case, rc = get_case(name, n), ref_case(name, n)
    mesh = _mesh4()
    for dtype in (np.float64, np.float32):
        env = build_env(case, dtype, seed=11)
        want = _ref_run(rc, env, dtype)
        scale = max(np.abs(v).max() for v in want.values())
        for backend in ("torch", "hopper"):
            res = race(case.program, reassociate=case.reassociate,
                       rewrite_div=case.rewrite_div, backend=backend)
            for strategy in ("exchange", "recompute"):
                got = res.run_sharded(dict(env), mesh, halo=strategy)
                assert set(got) == set(want)
                assert all(str(got[k].dtype) == f"torch.{want[k].dtype}"
                           for k in want)
                if dtype is np.float64:
                    err = max(float(np.abs(got[k].numpy() - want[k]).max())
                              for k in want)
                    assert err <= 1e-10 * scale, (backend, strategy, err)
                else:
                    assert rel_err(got, want) <= default_tolerances(
                        dtype)["plan"], (backend, strategy)
            sr = compile_sharded(res, env_to_torch(env, CPU), mesh,
                                 backend=backend, halo="exchange")
            assert sr.backend == backend
            assert sr.calls == 1


@pytest.mark.parametrize("name,n,code", REFUSED)
def test_registry_refusals_match_reference(name, n, code):
    case = get_case(name, n)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div, backend="torch")
    with pytest.raises(ShardingUnavailable) as ei:
        res.run_sharded(build_env(case, np.float64, seed=11), _mesh4())
    assert any(r.code == code for r in ei.value.refusals)
    assert {r.code for r in ei.value.refusals} == _codes(
        _ref_partition(name, n))


# ---------------------------------------------------------------------------
# gradients on the 4-shard mesh against jax.grad of the reference
# ---------------------------------------------------------------------------


def _weights(n):
    return np.cos(np.arange(n))


def _float_keys(env):
    return sorted(k for k, v in env.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating))


@pytest.mark.parametrize("name,n", [("poisson", 10), ("j3d27pt", 10),
                                    ("hdifft_gm", 14), ("mirror_deriv", 14)])
def test_sharded_gradient_matches_reference(name, n):
    case, rc = get_case(name, n), ref_case(name, n)
    env = build_env(case, np.float64, seed=11)
    keys = _float_keys(env)
    with _x64_ctx(np.float64):
        rres = ref_race(rc.program, reassociate=rc.reassociate,
                        rewrite_div=rc.rewrite_div, backend="xla")

        def loss(p):
            outs = rres.run({**env, **p}, "xla")
            return sum(jnp.sum(v * jnp.asarray(
                _weights(v.size).reshape(v.shape), v.dtype))
                for v in outs.values())

        want = {k: np.asarray(v) for k, v in jax.grad(loss)(
            {k: jnp.asarray(env[k]) for k in keys}).items()}
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div, backend="torch")
    mesh = _mesh4()
    obs.configure(enabled=True)
    p = {k: torch.tensor(env[k], requires_grad=True) for k in keys}
    outs = res.run_sharded({**env, **p}, mesh)
    total = sum((v * torch.as_tensor(_weights(v.numel()).reshape(
        tuple(v.shape)))).sum() for v in outs.values())
    gs = torch.autograd.grad(total, [p[k] for k in keys], allow_unused=True)
    got = {k: torch.zeros_like(p[k]) if g is None else g
           for k, g in zip(keys, gs)}
    assert rel_err(got, want) <= default_tolerances(np.float64)["grad"]
    # each adjoint spec shards exactly where the reference's partitioner
    # admits the same adjoint program on the same mesh shape
    sr = compile_sharded(res, env_to_torch(env, CPU), mesh, backend="torch")
    decided = {inp: isinstance(ex, ShardedRace)
               for inp, ex in sr.adjoint_executors().items()}
    ref_specs = {s.input: s for s in ref_adjoint_build(rc.program).specs}
    assert set(decided) == {k for k in keys if k in ref_specs}
    for inp, sharded in decided.items():
        ref_ok = ref_plan_partition(ref_specs[inp].program,
                                    FakeMesh(sx=2, sy=2)).ok
        assert sharded == ref_ok, inp
    fallbacks = {e["input"] for e in obs.events("shard_adjoint_fallback")}
    assert fallbacks == {inp for inp, s in decided.items() if not s}
    counters = obs.dump()["metrics"]["counters"]
    assert any("stencil-sharded" in k for k in counters)


def test_sharded_gradient_autodiff_gate(monkeypatch):
    """``RACE_ADJOINT=autodiff`` and an adjoint build refusal take autograd
    of the baseline, as the unsharded backward does."""
    obs.configure(enabled=True)
    monkeypatch.setenv("RACE_ADJOINT", "autodiff")
    case = get_case("poisson", 10)
    env = build_env(case, np.float64, seed=2)
    res = race(case.program, reassociate=case.reassociate, backend="torch")
    key = sorted(res.run(env, device=CPU))[0]
    grads = []
    for run in (lambda e: res.run(e, device=CPU),
                lambda e: res.run_sharded(e, _mesh4())):
        u = torch.tensor(env["u"], requires_grad=True)
        grads.append(torch.autograd.grad(run({**env, "u": u})[key].sum(),
                                         u)[0])
    assert rel_err({"u": grads[1]}, {"u": grads[0]}) <= 1e-12
    counters = obs.dump()["metrics"]["counters"]
    assert any("autodiff-sharded" in k for k in counters)


def test_sharded_second_order_never_returns_none():
    """Under ``create_graph`` the sharded backward differentiates again: a
    Hessian-vector product through ``run_sharded`` equals the one through
    the single-device ``run``."""
    case = get_case("poisson", 10)
    env = build_env(case, np.float64, seed=9)
    res = race(case.program, reassociate=case.reassociate, backend="torch")
    key = sorted(res.run(env, device=CPU))[0]
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, env["u"].shape))
    hvps = []
    for run in (lambda e: res.run(e, device=CPU),
                lambda e: res.run_sharded(e, _mesh4())):
        u = torch.tensor(env["u"], requires_grad=True)
        out = run({**env, "u": u})[key]
        (g,) = torch.autograd.grad((out ** 2).sum(), u, create_graph=True)
        assert g is not None and g.requires_grad
        (h,) = torch.autograd.grad((g * v).sum(), u)
        assert h is not None
        hvps.append(h)
    assert rel_err({"h": hvps[1]}, {"h": hvps[0]}) <= default_tolerances(
        np.float64)["grad"]


def test_sharded_adjoint_falls_back_where_refused():
    """``y[i, j] = u[i, j] * c[i, j] + u[i + 1, j + 1]`` shards on 2x2 (both
    extents 8), but ``u``'s adjoint ranges over the 9 x 9 access hull, which
    no axis of 2 divides: that spec runs on the single-device executor
    (one ``shard_adjoint_fallback`` event) while ``c``'s shards, as the
    reference's partitioner decides, and the gradients equal the
    single-device ones."""
    from repro.core.ir import arr as ref_arr
    from repro.core.ir import loopnest as ref_loopnest
    from repro.core.ir import program as ref_program

    def build(arr_, loopnest_, program_):
        u, c, y = arr_("u"), arr_("c"), arr_("y")
        loops, (i, j) = loopnest_(("i", 0, 7), ("j", 0, 7))
        return program_(loops, [(y[i, j], u[i, j] * c[i, j]
                                 + u[i + 1, j + 1])])

    prog = build(arr, loopnest, program)
    rprog = build(ref_arr, ref_loopnest, ref_program)
    rng = np.random.default_rng(3)
    env = {"u": rng.uniform(-1, 1, (9, 9)), "c": rng.uniform(-1, 1, (8, 8))}
    res = race(prog, backend="torch")
    mesh = _mesh4()
    obs.configure(enabled=True)
    grads = []
    for run in (lambda e: res.run(e, device=CPU),
                lambda e: res.run_sharded(e, mesh)):
        p = {k: torch.tensor(v, requires_grad=True) for k, v in env.items()}
        out = run(p)["y"]
        grads.append(dict(zip(p, torch.autograd.grad(
            (out * out).sum(), list(p.values())))))
    assert rel_err(grads[1], grads[0]) <= default_tolerances(
        np.float64)["grad"]
    sr = compile_sharded(res, env_to_torch(env, CPU), mesh, backend="torch")
    decided = {inp: isinstance(ex, ShardedRace)
               for inp, ex in sr.adjoint_executors().items()}
    ref = {s.input: ref_plan_partition(s.program, FakeMesh(sx=2, sy=2)).ok
           for s in ref_adjoint_build(rprog).specs}
    assert decided == ref == {"u": False, "c": True}
    evs = obs.events("shard_adjoint_fallback")
    assert [e["input"] for e in evs] == ["u"]
    assert any(S_NO_AXIS in r for r in evs[0]["reasons"])
