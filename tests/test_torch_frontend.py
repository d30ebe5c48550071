"""The port's capture frontend, ``repro_torch.frontend``, against the
reference's ``repro.frontend``.

Both packages capture the same plain-Python source: the six registry twins
must give programs with the reference's hashes and plans, every rejection
of ``tests/test_frontend_diagnostics.py`` the reference's code, line and
column, and the frontend sweep the reference's outputs within ``plan``.
The decorator surface (``race_kernel``, ``race_from_fn``) runs on the CPU
with ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import test_frontend_diagnostics as ref_diag
from test_torch_seed import (SEED_DEPENDENT_PLANS, ref_plan_record,
                             reference_under_seed0)
from repro.apps.frontend_kernels import TWINS as REF_TWINS
from repro.apps.paper_kernels import get_case as ref_get_case
from repro.core.executor import program_hash as ref_program_hash
from repro.core.race import race as ref_race
from repro.frontend import capture as ref_capture
from repro.testing import build_env as ref_build_env
from repro.testing import sweep_registry as ref_sweep_registry
from repro_torch import RaceKernel, race, race_from_fn, race_kernel
from repro_torch.apps.frontend_kernels import TWINS, as_frontend
from repro_torch.apps.paper_kernels import get_case
from repro_torch.core.codegen import FUNCS, required_shapes
from repro_torch.core.executor import program_hash
from repro_torch.core.ir import Node, SourceLoc
from repro_torch.frontend import (ALL_CODES, KNOWN_CALLS, CaptureError,
                                  D_UNKNOWN_CALL, FrontendDiagnostic,
                                  capture)
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 rel_err, sweep_registry)

pytestmark = pytest.mark.port

CPU = "cpu"


def _host(outs: dict) -> dict:
    return {k: np.asarray(v) for k, v in outs.items()}


# --------------------------------------------------------------------------
# registry twins: the reference's programs and plans
# --------------------------------------------------------------------------


def test_twins_are_the_references():
    assert sorted(TWINS) == sorted(REF_TWINS)


@pytest.fixture(scope="module")
def seed0():
    """The reference's records, under PYTHONHASHSEED=0, of the twins whose
    reference plan follows the seed (F7; the port's does not)."""
    return reference_under_seed0(sorted({
        ("plan", name, SWEEP_SIZES[name], get_case(name).reassociate,
         "frontend") for name in TWINS
        if (name, get_case(name).reassociate) in SEED_DEPENDENT_PLANS}))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_captures_to_the_reference_program(name, seed0):
    n = SWEEP_SIZES[name]
    case = get_case(name, n)
    fe = get_case(name, n, via="frontend")  # capture equality checked
    assert fe.program == case.program
    ref_fe = ref_get_case(name, n, via="frontend")
    assert program_hash(fe.program) == ref_program_hash(ref_fe.program)
    opts = dict(reassociate=case.reassociate, rewrite_div=case.rewrite_div)
    got = race(fe.program, **opts)
    key = ("plan", name, n, case.reassociate, "frontend")
    want = seed0.get(key) or ref_plan_record(*key[1:])
    assert got.to_source() == want["to_source"]
    assert got.reduced_ops() == want["reduced_ops"]
    assert got.n_aux() == want["n_aux"]
    assert got.to_source() == race(case.program, **opts).to_source()


def test_captured_programs_carry_source_locations():
    case = get_case("psinv", 10)
    fe = as_frontend(case)
    assert isinstance(fe.program.loc, SourceLoc)
    assert fe.program.loc.file.endswith("frontend_kernels.py")
    assert "repro_torch" in fe.program.loc.file
    for st in fe.program.body:
        assert isinstance(st.loc, SourceLoc)
        assert st.loc.line > fe.program.loc.line
    assert fe.program == case.program and case.program.loc is None


def test_get_case_rejects_unknown_via_and_missing_twin():
    with pytest.raises(ValueError, match="unknown via"):
        get_case("psinv", 10, via="tracing")
    with pytest.raises(KeyError, match="no plain-Python twin"):
        get_case("derivative", 10, via="frontend")
    # the errors are the reference's
    with pytest.raises(ValueError, match="unknown via"):
        ref_get_case("psinv", 10, via="tracing")
    with pytest.raises(KeyError, match="no plain-Python twin"):
        ref_get_case("derivative", 10, via="frontend")


# --------------------------------------------------------------------------
# rejections: the reference's diagnostics
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "fn,code", ref_diag.REJECTIONS,
    ids=[f.__name__.lstrip("_") for f, _ in ref_diag.REJECTIONS])
def test_rejection_gives_the_reference_diagnostic(fn, code):
    with pytest.raises(CaptureError) as got:
        capture(fn, ref_diag.SHAPES)
    with pytest.raises(ref_diag.CaptureError) as want:
        ref_capture(fn, ref_diag.SHAPES)
    d, r = got.value.diagnostic, want.value.diagnostic
    assert isinstance(d, FrontendDiagnostic)
    assert d.code == r.code == code
    assert (d.line, d.col) == (r.line, r.col)
    assert (d.file, d.function, d.message) == (r.file, r.function, r.message)
    assert str(d) == str(r)


def test_diagnostic_codes_are_the_references():
    assert ALL_CODES == ref_diag.ALL_CODES
    assert {code for _, code in ref_diag.REJECTIONS} == set(ALL_CODES)


def test_missing_shape_is_api_error_not_diagnostic():
    def k(u, out):
        n, m = u.shape
        for i in range(1, n):
            for j in range(1, m):
                out[i, j] = u[i, j]

    with pytest.raises(ValueError, match="shape for parameter 'out'"):
        capture(k, {"u": (10, 10)})


# --------------------------------------------------------------------------
# known calls: math/numpy/abs, and torch where the reference takes jax
# --------------------------------------------------------------------------


def test_known_calls_mirror_codegen_funcs():
    assert set(KNOWN_CALLS) == set(FUNCS)


def test_torch_callables_are_known_impls():
    def f(u, out):
        n = len(u)
        for i in range(1, n):
            out[i] = torch.sqrt(u[i]) + torch.abs(u[i - 1])

    prog = capture(f, {"u": (6,), "out": (6,)})
    names = [k.kids[0].name for k in prog.body[0].rhs.kids]
    assert names == ["sqrt", "abs"]


def test_a_same_named_callable_outside_torch_is_refused():
    class Impostor:
        @staticmethod
        def sin(x):
            return x

    Impostor.sin.__module__ = "torchvision_like"
    fake = Impostor()

    def f(u, out):
        n = len(u)
        for i in range(1, n):
            out[i] = fake.sin(u[i])

    with pytest.raises(CaptureError) as exc:
        capture(f, {"u": (6,), "out": (6,)})
    assert exc.value.diagnostic.code == D_UNKNOWN_CALL


def test_numpy_attribute_calls_resolve_to_known_impls():
    def f(u, out):
        n = len(u)
        for i in range(1, n):
            out[i] = np.sqrt(u[i])

    prog = capture(f, {"u": (6,), "out": (6,)})
    assert prog.body[0].rhs.op == "call"
    assert prog.body[0].rhs.kids[0].name == "sqrt"


# --------------------------------------------------------------------------
# the decorator / convenience surface, on the CPU
# --------------------------------------------------------------------------


def _blur(u, out):
    n, m = u.shape
    for i in range(1, n - 1):
        for j in range(1, m - 1):
            out[i, j] = (u[i - 1, j] + u[i + 1, j]) / 2.0


def _blur_env(seed, shape):
    return {"u": np.random.default_rng(seed).uniform(-1, 1, shape)
            .astype(np.float32), "out": np.zeros(shape, np.float32)}


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_race_from_fn_runs_on_backend_layer(backend):
    shapes = {"u": (10, 8), "out": (10, 8)}
    res = race_from_fn(_blur, shapes, reassociate=0)
    env = _blur_env(0, (10, 8))
    got = res.run(env, backend=backend, device=CPU)
    want = (env["u"][:-2, 1:-1] + env["u"][2:, 1:-1]) / 2
    np.testing.assert_allclose(np.asarray(got["out"]), want, rtol=1e-6)
    assert got["out"].device.type == "cpu"


def test_race_from_fn_equals_the_references_plan():
    shapes = {"u": (10, 8), "out": (10, 8)}
    got = race_from_fn(_blur, shapes, reassociate=3)
    want = ref_race(ref_capture(_blur, shapes), reassociate=3)
    assert got.to_source() == want.to_source()
    assert got.telemetry()["plan"] == want.telemetry()["plan"]


def test_race_kernel_decorator_caches_and_runs():
    kern = race_kernel(reassociate=0)(_blur)
    assert isinstance(kern, RaceKernel)
    assert kern.__name__ == "_blur"
    env = _blur_env(1, (12, 9))
    got = kern.run(env, device=CPU)
    want = (env["u"][:-2, 1:-1] + env["u"][2:, 1:-1]) / 2
    np.testing.assert_allclose(np.asarray(got["out"]), want, rtol=1e-6)
    shapes = {k: np.shape(v) for k, v in env.items()}
    assert kern.trace(shapes) is kern.trace(shapes)
    assert kern.capture(shapes) is kern.capture(shapes)
    assert kern.last_capture_seconds is not None
    with pytest.raises(ValueError, match="needs inputs"):
        kern.run({"u": env["u"]}, device=CPU)


def test_race_kernel_defaults_to_the_card():
    """Like every entry point, the decorator runs on cuda unless the caller
    asks for the CPU: with no card present that raises, it never quietly
    runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    kern = race_kernel(_blur, reassociate=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kern.run(_blur_env(2, (8, 8)))


def test_race_kernel_reads_tensor_shapes_without_a_host_copy(monkeypatch):
    """Shapes come off ``.shape``: a tensor is never turned into a numpy
    array to learn its shape (on the card that would be a device-to-host
    copy)."""
    kern = race_kernel(_blur, reassociate=0)
    env = {k: torch.as_tensor(v) for k, v in _blur_env(3, (10, 7)).items()}

    def refuse(*a, **k):
        raise AssertionError("a tensor was converted to a numpy array")

    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    got = kern.run(env, "hopper", device=CPU)
    want = (env["u"][:-2, 1:-1] + env["u"][2:, 1:-1]) / 2
    torch.testing.assert_close(got["out"], want)
    meta = {k: torch.empty((10, 7), device="meta") for k in env}
    assert kern._shapes_from_env(meta) == {"u": (10, 7), "out": (10, 7)}
    stacked = {k: torch.stack([v, v]) for k, v in env.items()}
    outs = kern.run_batch(stacked, "hopper", device=CPU)
    torch.testing.assert_close(outs["out"][1], want)


def test_race_kernel_run_batch_equals_run():
    kern = race_kernel(_blur, reassociate=0)
    envs = [_blur_env(s, (9, 8)) for s in range(3)]
    outs = kern.run_batch(envs, "torch", device=CPU)
    for b, env in enumerate(envs):
        one = kern.run(env, "torch", device=CPU)
        torch.testing.assert_close(outs["out"][b], one["out"])


def test_race_kernel_on_registry_twin_matches_dsl_result():
    case = get_case("calc_tpoints", SWEEP_SIZES["calc_tpoints"])
    kern = race_kernel(TWINS["calc_tpoints"], reassociate=case.reassociate)
    env = build_env(case, np.float32)
    got = kern.run(env, backend="hopper", device=CPU)
    want = race(case.program, reassociate=case.reassociate).run(
        env, "hopper", device=CPU)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_capture_consts_parameterize_bounds():
    def roll(u, out, n):
        for i in range(1, n):
            out[i] = u[i] + u[i - 1]

    prog = capture(roll, {"u": (16,), "out": (16,)}, consts={"n": 16})
    assert prog.loops[0].hi == 15
    prog8 = capture(roll, {"u": (16,), "out": (16,)}, consts={"n": 8})
    assert prog8.loops[0].hi == 7
    assert program_hash(prog8) == ref_program_hash(
        ref_capture(roll, {"u": (16,), "out": (16,)}, consts={"n": 8}))


def test_run_with_consts_bound_parameter():
    def roll(u, out, n):
        for i in range(1, n):
            out[i] = u[i] + u[i - 1]

    kern = race_kernel(roll, reassociate=0)
    env = {"u": np.arange(8, dtype=np.float32),
           "out": np.zeros(8, np.float32)}
    got = kern.run(env, consts={"n": 8}, device=CPU)
    np.testing.assert_allclose(np.asarray(got["out"]),
                               env["u"][1:] + env["u"][:-1])


def test_capture_negative_and_strided_subscripts():
    def mixed(u, out):
        n, m = u.shape
        for i in range(1, 5):
            for j in range(0, 4):
                out[i, j] = u[2 * i + 1, j] + u[8 - i, 3 * j]

    shapes = {"u": (12, 12), "out": (12, 12)}
    prog = capture(mixed, shapes)
    assert program_hash(prog) == ref_program_hash(ref_capture(mixed, shapes))
    (st,) = prog.body
    a, b = st.rhs.kids
    assert (a.subs[0].a, a.subs[0].b) == (2, 1)
    assert (b.subs[0].a, b.subs[0].b) == (-1, 8)
    assert b.subs[1].a == 3
    env = {"u": np.random.default_rng(2).uniform(-1, 1, (12, 12))
           .astype(np.float32), "out": np.zeros((12, 12), np.float32)}
    want = np.zeros((4, 4), np.float32)
    for i in range(1, 5):
        for j in range(0, 4):
            want[i - 1, j] = env["u"][2 * i + 1, j] + env["u"][8 - i, 3 * j]
    # negative coefficients stay executable: the probe sends the plan to
    # "torch", as the reference's sends it to "xla"
    res = race(prog)
    assert res.select_backend("auto").backend == "torch"
    got = np.asarray(res.run(env, "auto", device=CPU)["out"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref_got = np.asarray(ref_race(ref_capture(mixed, shapes)).run(
        env, "xla")["out"])
    np.testing.assert_allclose(got, ref_got, rtol=1e-6)


def test_capture_augmented_assignment_desugars():
    def accum(u, out):
        n = len(u)
        for i in range(1, n - 1):
            out[i] += u[i + 1] * u[i - 1]

    prog = capture(accum, {"u": (9,), "out": (9,)})
    (st,) = prog.body
    assert isinstance(st.rhs, Node) and st.rhs.op == "+"
    assert st.rhs.kids[0] == st.lhs


def test_numpy_scalars_are_capture_time_values():
    def scaled(u, out, n, w):
        for i in range(1, n):
            out[i] = w * u[i] + u[i - np.int64(1)]

    prog = capture(scaled, {"u": (8,), "out": (8,)},
                   consts={"n": np.int32(8), "w": np.float32(0.5)})
    assert prog.loops[0].hi == 7
    (st,) = prog.body
    coef, _ = st.rhs.kids[0].kids
    assert coef.val == 0.5
    assert st.rhs.kids[1].subs[0].b == -1


def test_captured_semantics_match_direct_python_execution():
    """The twin is executable Python: running it directly agrees with the
    captured program's baseline evaluator."""
    case = get_case("poisson", 8)
    shapes = required_shapes(case.program)
    env = build_env(case, np.float64)
    direct = {k: np.array(v, np.float64) for k, v in env.items()}
    TWINS["poisson"](direct["u"], direct["fp"], direct["pois"],
                     float(direct["pc0"]), float(direct["pc1"]),
                     float(direct["pc2"]))
    prog = capture(TWINS["poisson"], shapes)
    tenv = {k: torch.as_tensor(v) for k, v in env.items()}
    got = race(prog).baseline_evaluator()(tenv)["pois"]
    np.testing.assert_allclose(got.numpy(), direct["pois"], rtol=1e-12,
                               atol=1e-12)


# --------------------------------------------------------------------------
# the frontend sweep against the reference's
# --------------------------------------------------------------------------


def test_frontend_sweep_agrees_with_the_references():
    """``sweep_registry(via="frontend")`` in both packages: the same
    twinned cases, the same aux counts per level, every combo ok (the
    port's on ``"torch"`` and the tile emulator, the reference's on
    ``"xla"``); the outputs themselves are compared below."""
    levels = (0, 3)
    reports = sweep_registry(via="frontend", device=CPU,
                             reassociate_levels=levels)
    ref_reports = ref_sweep_registry(via="frontend",
                                     reassociate_levels=levels,
                                     backends=("xla",))
    assert [r.case for r in reports] == [r.case for r in ref_reports]
    assert sorted(r.case for r in reports) == sorted(TWINS)
    assert not [f for r in reports for f in r.failures()]
    assert not [f for r in ref_reports for f in r.failures()]
    assert all(c.status == "ok" for r in reports for c in r.combos)
    aux = {(r.case, c.reassociate): c.n_aux for r in reports
           for c in r.combos}
    ref_aux = {(r.case, c.reassociate): c.n_aux for r in ref_reports
               for c in r.combos}
    assert aux == ref_aux


@pytest.mark.parametrize("name", sorted(TWINS))
def test_frontend_case_outputs_equal_the_references(name):
    """The port's frontend case on the kernel's plain version (the tile
    emulator) and on ``"torch"`` against the reference's frontend case on
    ``"xla"``, at the same plan, on the same inputs, within ``plan``."""
    n = SWEEP_SIZES[name]
    case = get_case(name, n, via="frontend")
    ref_case = ref_get_case(name, n, via="frontend")
    env = build_env(case, np.float32)
    res = race(case.program, reassociate=case.reassociate,
               rewrite_div=case.rewrite_div)
    ref_res = ref_race(ref_case.program, reassociate=ref_case.reassociate,
                       rewrite_div=ref_case.rewrite_div)
    want = _host(ref_res.run(ref_build_env(ref_case, np.float32), "xla"))
    tol = default_tolerances(np.float32)["plan"]
    for backend in ("torch", "hopper"):
        got = _host(res.run(env, backend, device=CPU))
        assert rel_err(got, want) <= tol, backend
