"""K1 reads an adjoint's zero-padded cotangent in place: the pad is part of
the operand's description (``lowering/emit.py: Operand.lo``, ``stored``,
:func:`pad_operands`), not a canvas that ``F.pad`` fills and copies
(``core/adjoint.py: _run_unit``).  On the CPU through the tile emulator:
every registry backward K1 admits, at every dtype it admits, one example
and batched, gives the canvas path's gradients bit for bit; asymmetric pads
and pads wider than the halo read as the canvas; zero pads render the
parent's source byte for byte; ``race_adjoint_pads_total`` counts which
feeds K1 read in place.  Imports no jax."""
import hashlib
import importlib.util
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F

import repro_torch
from repro_torch import obs
from repro_torch.apps import CASES, get_case
from repro_torch.core import adjoint
from repro_torch.core.backend import probe_hopper
from repro_torch.core.codegen import required_shapes
from repro_torch.core.executor import compile_plan, operand_dtypes
from repro_torch.launch.mesh import make_stencil_mesh
from repro_torch.lowering.emit import (KERNEL_DTYPES, emulate, pad_operands,
                                       render_cuda, specialize_stencil,
                                       tile_program)
from repro_torch.testing import SWEEP_SIZES, torch_env

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


def _counts() -> dict:
    return {k: v for k, v in obs.snapshot()["counters"].items()
            if k.startswith("race_adjoint_pads_total")}


def _cotangents(program, lead: tuple, dtype, seed: int) -> dict:
    """A seeded cotangent per output, over its interior, in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    full = program.ranges()
    out = {}
    for st in program.body:
        shape = lead + tuple(full[s.s][1] - full[s.s][0] + 1
                             for s in st.lhs.subs)
        out[st.lhs.name] = (torch.rand(shape, generator=gen,
                                       dtype=torch.float64) * 2 - 1).to(dtype)
    return out


def _units(program) -> list:
    """Every adjoint program a backward of every input may run: each spec,
    and the scalars' group where there is one."""
    build = adjoint.adjoint_build(program)
    group = build.scalar_group([s.input for s in build.specs])
    return list(build.specs) + ([group] if group is not None else [])


def _canvas_grads(unit, env, g, batched: bool) -> dict:
    """The parent's backward of one unit: the padded canvas env
    (:func:`~repro_torch.core.adjoint.assemble_adjoint_env`) through the
    executor of its signature."""
    a = adjoint.assemble_adjoint_env(unit, env, g)
    ex = compile_plan(unit.result().plan,
                      adjoint.adjoint_signature(unit, env, g, batched),
                      "hopper", device=CPU)
    if unit.scalar:
        out = ex.run_sum(a, batched)
    else:
        out = ex.run_batch(a) if batched else ex.run(a)
    return {s.input: adjoint.finalize_adjoint(s, env, out[s.gu])
            for s in unit.members}


#: the registry's cases with an adjoint program that reads a zero-padded
#: cotangent (rprj3's and diag2d's builds refuse; ocn_export's adjoints
#: read every cotangent at its own shape)
PADDED = ("blocked4d", "calc_tpoints", "derivative", "diffusion1",
          "diffusion2", "diffusion3", "gaussian", "hdifft_gm", "j3d27pt",
          "mirror_deriv", "poisson", "psinv", "resid", "rhs_ph1", "rhs_ph2",
          "smooth1d")


def test_padded_cases_are_every_registry_case_with_a_padded_cotangent():
    got = {name for name in CASES if any(
        adjoint.cotangent_pads(u) for u in _units(
            get_case(name, SWEEP_SIZES[name]).program))}
    assert got == set(PADDED)


@pytest.mark.parametrize("name", PADDED)
def test_in_place_cotangent_gives_the_canvas_gradients_bit_for_bit(name):
    """Every registry backward K1 admits, at every kernel dtype it admits,
    one example and a batch of two: ``_run_unit`` (the raw cotangent with
    its pads, K1 reading it in place) gives exactly the gradients of the
    canvas (``F.pad``) path."""
    case = get_case(name, SWEEP_SIZES[name])
    units = [u for u in _units(case.program) if adjoint.cotangent_pads(u)]
    ran = 0
    for dt in KERNEL_DTYPES:
        tdt = getattr(torch, dt)
        envs = [torch_env(case, "float32", seed=s, device=CPU)
                for s in (0, 1)]
        envs = [{k: v.to(tdt) if v.is_floating_point() else v
                 for k, v in e.items()} for e in envs]
        stacked = {k: torch.stack([e[k] for e in envs]) for k in envs[0]}
        for unit in units:
            plan = unit.result().plan
            for batched in (False, True):
                env = stacked if batched else envs[0]
                lead = (2,) if batched else ()
                g = _cotangents(case.program, lead, tdt, seed=7)
                sig = adjoint.adjoint_signature(unit, env, g, batched)
                if not probe_hopper(plan, operand_dtypes(plan, sig)).eligible:
                    continue
                obs.configure(enabled=True)
                got = adjoint._run_unit(unit, env, g, "hopper", batched)
                assert {k: v for k, v in _counts().items()
                        if "kind=cotangent" in k} == {
                    "race_adjoint_pads_total{how=kernel,kind=cotangent}":
                        float(len(adjoint.cotangent_pads(unit)))}, _counts()
                obs.reset()
                want = _canvas_grads(unit, env, g, batched)
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, (name, dt, k)
                    assert torch.equal(got[k], want[k]), (name, dt, k,
                                                          batched)
                ran += 1
    assert ran, f"{name}: K1 admits no adjoint that reads a padded cotangent"


def _forward_program(name: str, n: int, dtype: str, pads: dict):
    """A registry case's forward tile program at ``dtype``, its env, and
    the same env with each array of ``pads`` cut to what lies inside them
    (what K1 reads in place) beside the zero-padded canvas it stands
    for."""
    case = get_case(name, n)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    shapes = required_shapes(case.program)
    tp = tile_program(res.plan, shapes, {k: dtype for k in shapes})
    env = torch_env(case, dtype, seed=3, device=CPU)
    canvas, raw = dict(env), dict(env)
    for nm, p in pads.items():
        inner = tuple(slice(lo, size - hi) for size, (lo, hi) in
                      zip(env[nm].shape, p))
        raw[nm] = env[nm][inner].contiguous()
        canvas[nm] = F.pad(raw[nm], tuple(x for lo, hi in reversed(p)
                                          for x in (lo, hi)))
    return tp, raw, canvas


#: per case, pads of its first operand: asymmetric, one wider than the
#: stencil's reach (every point near that face reads zeros alone), and a
#: zero pad on one side
PADS = {
    "j3d27pt": {"u": ((1, 3), (5, 0), (0, 2))},  # staged windows
    "rprj3": {"Rf": ((2, 0), (0, 4), (3, 1))},  # strided reads in place
    "mirror_deriv": {"u": ((0, 5), (4, 1))},  # mirrored reads in place
    "diag2d": {"u": ((3, 0), (1, 6))},
    "blocked4d": {"T4": ((1, 0), (0, 2), (3, 0), (0, 1))},
}


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PADS))
def test_asymmetric_and_wide_pads_read_as_the_canvas(name, dtype):
    """A forward plan whose operand comes without an asymmetric zero pad,
    some sides wider than the halo: the emulator over the unpadded array
    (:func:`pad_operands`) gives the canvas's outputs bit for bit, at the
    chooser's tile and at small forced tiles, one example and summed."""
    n = 2 * SWEEP_SIZES[name]
    tp, raw, canvas = _forward_program(name, n, dtype, PADS[name])
    for forced in ((0, 0, 0), (4, 2, 3)):
        if forced != (0, 0, 0):
            case = get_case(name, n)
            res = repro_torch.race(case.program, reassociate=case.reassociate)
            shapes = required_shapes(case.program)
            tp = tile_program(res.plan, shapes, {k: dtype for k in shapes},
                              *forced)
        padded = pad_operands(tp, PADS[name])
        (nm, p), = PADS[name].items()
        op = next(o for o in padded.operands if o.name == nm)
        assert op.shape == tuple(canvas[nm].shape)
        assert op.stored == tuple(raw[nm].shape)
        assert op.lo == tuple(lo for lo, _ in p)
        assert padded.geometry == tp.geometry
        want, got = emulate(tp, canvas), emulate(padded, raw)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, forced, k)
        want, got = emulate(tp, canvas, True), emulate(padded, raw, True)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, forced, k)


def test_wrapper_checks_the_stored_shape_and_batches_on_it():
    """The wrapper's batch runs over the unpadded operand, each example's
    pointer stepping by the stored elements; a canvas-shaped operand with
    pads or a cut one without them does not pass for the other."""
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    shapes = required_shapes(case.program)
    dtypes = {k: "float32" for k in shapes}
    spec = specialize_stencil(res.plan, shapes, dtypes)
    pads = {"u": ((1, 2), (0, 1), (2, 0))}
    cut = specialize_stencil(res.plan, shapes, dtypes, pads=pads)
    assert cut.tp.geometry == spec.tp.geometry
    assert cut.tp.example_elems[0] == (9 * 11 * 10,)
    assert spec.tp.example_elems[0] == (12 ** 3,)
    envs = [torch_env(case, "float32", seed=s, device=CPU) for s in (0, 1)]
    raw = [dict(e, u=e["u"][1:10, 0:11, 2:12].contiguous()) for e in envs]
    canvas = [dict(e, u=F.pad(r["u"], (2, 0, 0, 1, 1, 2)))
              for e, r in zip(envs, raw)]
    stacked = {k: torch.stack([r[k] for r in raw]) for k in raw[0]}
    got = cut.apply_batch(stacked)
    summed = cut.apply_sum(stacked, batched=True)
    for b in range(2):
        want = spec.apply(canvas[b])
        assert torch.equal(got["j27"][b], want["j27"])
        assert torch.equal(cut.apply(raw[b])["j27"], want["j27"])
        assert torch.equal(summed["j27"][b],
                           spec.apply_sum(canvas[b])["j27"])
    with pytest.raises(ValueError, match="no operand"):
        pad_operands(spec.tp, {"w": ((1, 0),) * 3})
    with pytest.raises(ValueError, match="leave nothing"):
        pad_operands(spec.tp, {"u": ((6, 6), (0, 0), (0, 0))})
    with pytest.raises(ValueError, match="do not fit"):
        pad_operands(spec.tp, {"u": ((1, 0),)})


def _bench_program(name: str, n: int):
    """The benchmark's frozen loop nest (``racebench/programs``)."""
    path = ROOT / "racebench" / "programs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(n)


#: sha256 of the sources the benchmark's cells run, rendered by the tree
#: before operands carried pads: forward (sweeps, grad's forward, the batch
#: of 256 at 64^3), and j3d27pt's backward at 512^3 (u's adjoint over its
#: canvas shape, the scalars' summed group)
PARENT_SOURCES = {
    "j3d27pt512.adjoint_u":
        "d9a4ec9e791ff898029e2e36e6dcd95dc1b1064534e281a281422cd95fe222e0",
    "j3d27pt512.forward.b1":
        "3b14d3cd9ea42cb133123ede2b36b604ec8b2d499543d376e2ec8fc870f407ed",
    "j3d27pt512.group":
        "bcba6882dad7b1e619bf8ed716370f5f0fd9e520dd38260b50a9e04cb3c8dcba",
    "j3d27pt64.forward.b256":
        "06d37b7e09596036df1f590ee9c2da77ab62227b1602a6112fa8d37333afd127",
    "psinv514.forward.b1":
        "3deae6452e1fc20defef667f9daf5cd6562e5a9ade2b3db2710c034a1d64aa4c",
}


def _sha(src: str) -> str:
    return hashlib.sha256(src.encode()).hexdigest()


@pytest.mark.parametrize("key", sorted(PARENT_SOURCES))
def test_zero_pads_render_the_parent_source_byte_for_byte(key):
    """The benchmark's forward kernels, the scalars' group and ``u``'s
    adjoint of j3d27pt: their sources, and the sources with every operand
    given zero pads, are the parent's byte for byte."""
    name, what = key.split(".", 1)
    program = name.rstrip("0123456789")
    n = int(name[len(program):])
    p = _bench_program(program, n)
    shapes = required_shapes(p)
    if what.startswith("forward"):
        dt = "float64" if program == "psinv" else "float32"
        res = repro_torch.race(p, reassociate=4 if program == "psinv" else 3)
        plan, adj, summed = res.plan, shapes, False
        batch = int(what.split(".b")[1])
    else:
        dt, batch = "float32", 1
        build = adjoint.adjoint_build(p)
        unit = (build.scalar_group([s.input for s in build.specs])
                if what == "group" else
                next(s for s in build.specs if s.input == "u"))
        plan, summed = unit.result().plan, unit.scalar
        adj = adjoint.adjoint_env_shapes(unit, p, shapes)
    spec = specialize_stencil(plan, adj, {k: dt for k in adj})
    assert _sha(spec.source_for(batch, summed)) == PARENT_SOURCES[key]
    tp = spec.program(batch)
    zero = {o.name: ((0, 0),) * len(o.shape) for o in tp.operands}
    assert _sha(render_cuda(pad_operands(tp, zero), summed)) == \
        PARENT_SOURCES[key]
    assert specialize_stencil(plan, adj, {k: dt for k in adj},
                              pads=zero).source_for(batch, summed) == \
        spec.source_for(batch, summed)


def test_u_adjoint_source_guards_and_addresses_the_raw_cotangent():
    """j3d27pt's ``u`` adjoint at 512^3 with the cotangent's pads: each
    staged window guards against the 510^3 cotangent and addresses it at
    its own pitch, the pad taken off the plane row and element indices
    (constants of the source); nothing else of the source changes."""
    p = _bench_program("j3d27pt", 512)
    build = adjoint.adjoint_build(p)
    unit = next(s for s in build.specs if s.input == "u")
    assert adjoint.cotangent_pads(unit) == {"_g_j27": ((2, 2),) * 3}
    adj = adjoint.adjoint_env_shapes(unit, p, required_shapes(p))
    assert adj["_g_j27"] == (514,) * 3
    dtypes = {k: "float32" for k in adj}
    pads = adjoint.cotangent_pads(unit)
    src = specialize_stencil(unit.result().plan, adj, dtypes,
                             pads=pads).source
    old = specialize_stencil(unit.result().plan, adj, dtypes).source
    assert "zz < 510;" in src and "zz < 514;" not in src
    assert "(j2) * 510 + (j3) * 1" in src and "* 514 +" not in src
    assert "bz * 132651000LL" in src  # 510^3 elements an example
    assert "j2 < 514" not in src and "j2 >= 0 && j2 < 510" in src
    changed = [a for a, b in zip(old.splitlines(), src.splitlines())
               if a != b]
    assert len(old.splitlines()) == len(src.splitlines())
    assert all(("zz" in ln or "const int j" in ln or "ok = zok" in ln
                or "race_stage" in ln or "bz *" in ln or "race_fetch" in ln)
               for ln in changed), changed


def _grad(res, env, keys, backend):
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p}, backend, device=CPU)
    g = {k: torch.cos(torch.arange(v.numel(), dtype=v.dtype)).reshape(
        v.shape) for k, v in out.items()}
    return torch.autograd.grad([out[k] for k in g], [p[k] for k in keys],
                               [g[k] for k in g])


def test_counter_counts_kernel_reads_once_per_u_adjoint():
    """A backward of every input through ``run`` on ``"hopper"``: ``u``'s
    adjoint reads its cotangent in place, once a backward, and nothing is
    padded into a canvas (the scalars' group reads the cotangent at its
    own shape)."""
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = torch_env(case, "float32", device=CPU)
    env.pop("j27")
    obs.configure(enabled=True)
    for backwards in (1, 2):
        _grad(res, env, sorted(env), "hopper")
        assert _counts() == {
            "race_adjoint_pads_total{how=kernel,kind=cotangent}":
                float(backwards)}


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_counter_counts_canvases_on_the_torch_backend(backend, monkeypatch):
    """With the adjoint plans on ``"torch"`` every padded feed is a canvas:
    j3d27pt's cotangent once a backward, and diffusion1's coefficient
    arrays (padded with ones) besides its cotangents.  On ``"hopper"`` the
    cotangents are read in place and the coefficient arrays stay canvases
    of ones."""
    monkeypatch.setenv("RACE_BACKEND", backend)
    obs.configure(enabled=True)
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = torch_env(case, "float32", device=CPU)
    env.pop("j27")
    _grad(res, env, ["u"], backend)
    how = "canvas" if backend == "torch" else "kernel"
    assert _counts() == {
        f"race_adjoint_pads_total{{how={how},kind=cotangent}}": 1.0}
    obs.reset()
    obs.configure(enabled=True)
    case = get_case("diffusion1", SWEEP_SIZES["diffusion1"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = torch_env(case, "float64", device=CPU)
    for st in case.program.body:
        env.pop(st.lhs.name, None)
    build = adjoint.adjoint_build(case.program)
    want = {}
    for s in build.specs:
        for kind, src, nm, pads in s.feeds:
            if kind == "cotangent" and any(lo or hi for lo, hi in pads):
                want[how, "cotangent"] = want.get((how, "cotangent"), 0) + 1
            if kind == "array" and adjoint._feed_pads(
                    kind, pads, env[src].shape) != ((0, 0),) * len(pads):
                want["canvas", "coefficient"] = want.get(
                    ("canvas", "coefficient"), 0) + 1
    assert ("canvas", "coefficient") in want
    _grad(res, env, [s.input for s in build.specs], backend)
    assert _counts() == {
        f"race_adjoint_pads_total{{how={h},kind={k}}}": float(n)
        for (h, k), n in want.items()}


def test_counter_counts_canvases_on_the_sharded_path():
    """The sharded backward keeps the canvas, and counts it."""
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = torch_env(case, "float32", device=CPU)
    env.pop("j27")
    mesh = make_stencil_mesh(4, ("sx", "sy"), devices=[CPU] * 4)
    obs.configure(enabled=True)
    u = env["u"].clone().requires_grad_()
    out = res.run_sharded({**env, "u": u}, mesh)
    torch.autograd.grad(out["j27"].sum(), u)
    assert _counts() == {
        "race_adjoint_pads_total{how=canvas,kind=cotangent}": 1.0}


def test_recorded_graph_keeps_the_canvas():
    """Under a recorded graph (a second-order backward) the pad is an
    autograd op, so the adjoint gets the canvas, on K1 too; an executor
    that reads the cotangent in place refuses to record."""
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = torch_env(case, "float32", device=CPU)
    env.pop("j27")
    u = env["u"].clone().requires_grad_()
    out = res.run({**env, "u": u}, "hopper", device=CPU)
    g = torch.cos(torch.arange(out["j27"].numel(), dtype=torch.float32)
                  ).reshape(out["j27"].shape).requires_grad_()
    obs.configure(enabled=True)
    (gu,) = torch.autograd.grad(out["j27"], u, g, create_graph=True)
    assert _counts() == {
        "race_adjoint_pads_total{how=canvas,kind=cotangent}": 1.0}
    (gg,) = torch.autograd.grad((gu * gu).sum(), g)
    assert gg.shape == g.shape and torch.isfinite(gg).all()
    build = adjoint.adjoint_build(case.program)
    unit = next(s for s in build.specs if s.input == "u")
    g2 = {"j27": g}
    assert adjoint.adjoint_executor(unit, env, g2, "hopper").pads == {}
    with torch.no_grad():
        ex = adjoint.adjoint_executor(unit, env, g2, "hopper")
    assert ex.pads == adjoint.cotangent_pads(unit)
    a = adjoint.assemble_adjoint_env(unit, env, g2, in_place=ex.pads)
    with pytest.raises(ValueError, match="records no graph"):
        ex.run(a)


def test_pads_are_part_of_the_executor_key():
    """``compile_plan``'s pads pick another K1 executor, one whose pads
    are bound at its build; zero pads, and any pads on the ``"torch"``
    evaluator, give the executor without them."""
    case = get_case("j3d27pt", 12)
    build = adjoint.adjoint_build(case.program)
    unit = next(s for s in build.specs if s.input == "u")
    env = torch_env(case, "float32", device=CPU)
    g = _cotangents(case.program, (), torch.float32, seed=1)
    plan = unit.result().plan
    sig = adjoint.adjoint_signature(unit, env, g)
    pads = adjoint.cotangent_pads(unit)
    canvas = compile_plan(plan, sig, "hopper", device=CPU)
    cut = compile_plan(plan, sig, "hopper", device=CPU, pads=pads)
    assert cut is not canvas and canvas.pads == {} and cut.pads == pads
    assert cut is compile_plan(plan, sig, "hopper", device=CPU,
                               pads=dict(pads))
    zero = {"_g_j27": ((0, 0),) * 3}
    assert compile_plan(plan, sig, "hopper", device=CPU,
                        pads=zero) is canvas
    t = compile_plan(plan, sig, "torch", device=CPU)
    assert compile_plan(plan, sig, "torch", device=CPU, pads=pads) is t
    assert t.pads == {}
    a = adjoint.assemble_adjoint_env(unit, env, g, in_place=cut.pads)
    assert tuple(a["_g_j27"].shape) == (10, 10, 10)
    want = canvas(adjoint.assemble_adjoint_env(unit, env, g))[unit.gu]
    assert torch.equal(cut(a)[unit.gu], want)


def test_wrappers_of_the_executor_reach_the_in_place_adjoint(monkeypatch):
    """The backward calls its executors as any caller does: a wrapper of
    ``CompiledRace._call`` sees ``u``'s adjoint (its cotangent unpadded)
    and the scalars' group, and a wrapper of one executor's ``run_sum``
    with ``run_sum``'s own arguments sees the group."""
    from repro_torch.core import executor

    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = torch_env(case, "float32", device=CPU)
    env.pop("j27")
    keys = sorted(env)
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p}, "hopper", device=CPU)
    g = {"j27": torch.cos(torch.arange(out["j27"].numel(),
                                       dtype=torch.float32)).reshape(
        out["j27"].shape)}
    units = adjoint.adjoint_runs(adjoint.adjoint_build(case.program), env,
                                 g, keys, "hopper")
    group = next(u for u in units if isinstance(u, adjoint.ScalarGroup))
    gex = adjoint.adjoint_executor(group, env, g, "hopper")
    seen, sums = [], []
    orig = executor.CompiledRace._call

    def call(self, env, batched, summed):
        seen.append((self.pads, {k: tuple(v.shape) for k, v in env.items()
                                 if k.startswith("_g_")}))
        return orig(self, env, batched, summed)

    def record(env, batched=False, _run=gex.run_sum):
        out = _run(env, batched)
        sums.append(out)
        return out

    monkeypatch.setattr(executor.CompiledRace, "_call", call)
    monkeypatch.setattr(gex, "run_sum", record, raising=False)
    torch.autograd.grad(out["j27"], [p[k] for k in keys], g["j27"])
    assert ({"_g_j27": ((2, 2),) * 3}, {"_g_j27": (10, 10, 10)}) in seen
    assert len(sums) == 1
