"""Constant subexpressions in the port's ``"torch"`` evaluator against the
reference's ``"xla"``.

A constant subtree (``sin(0.3)``, ``exp(0.1)``, ``math.sqrt(2.0)`` in a
captured loop, a right-hand side of no array) is evaluated at float64, as
the reference evaluates it under ``jax_enable_x64``, and meets the arrays
as a weak scalar, so it changes no array's dtype.  The programs are
``repro_torch.apps.constant_kernels``', built in both packages' IR from the
same builders, on the same numpy inputs (seeded), through every path that
runs the evaluator: ``"torch"``, ``"auto"`` (its fallback where K1 refuses,
else the kernel's tile emulator), ``run_batch`` (``vmap`` of the
evaluator), ``run_sharded`` on ``"torch"`` over a 2x2 mesh of CPU devices
and ``torch.autograd.grad`` through ``run`` with the adjoint plans on
``"torch"``.  Float64 within the ``plan`` tolerance, 1e-12; float32 and
bfloat16 outputs keep their dtype."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core.ir as ref_ir
from repro.core.race import race as ref_race
from repro.frontend import capture as ref_capture
from repro.testing.differential import _x64_ctx

import repro_torch
from repro_torch import race_kernel
from repro_torch.apps import constant_kernels as CK
from repro_torch.core import executor
from repro_torch.launch.mesh import make_stencil_mesh
from repro_torch.shard import ShardingUnavailable
from repro_torch.testing import default_tolerances, rel_err

pytestmark = pytest.mark.port

CPU = "cpu"
N = 30
PLAN64 = default_tolerances(np.float64)["plan"]
PROGRAMS = ["const", "sin", "exp_pair", "twin"]
PATHS = ["torch", "auto", "run_batch", "run_sharded", "grad"]


@pytest.fixture(autouse=True)
def fresh_executor_cache():
    executor.executor_cache().clear()
    yield
    executor.executor_cache().clear()


def _env(seed: int, dtype=np.float64) -> dict:
    u = np.random.default_rng(seed).uniform(-1, 1, N + 2).astype(dtype)
    return {"u": u, "o": np.zeros(N + 2, dtype)}


def _port(name):
    """The port's RaceResult of ``name`` at reassociate 3."""
    if name == "twin":
        return race_kernel(CK.twin, reassociate=3).trace(
            {"u": (N + 2,), "o": (N + 2,)})
    return repro_torch.race(CK.programs(n=N)[name], reassociate=3)


def _reference(name):
    if name == "twin":
        prog = ref_capture(CK.twin, {"u": (N + 2,), "o": (N + 2,)})
    else:
        prog = CK.programs(ref_ir, n=N)[name]
    return ref_race(prog, reassociate=3)


def _ref_run(name, env) -> dict:
    with _x64_ctx(np.float64):
        return {k: np.asarray(v)
                for k, v in _reference(name).run(env, "xla").items()}


def _weights(n):
    return np.cos(np.arange(n))


def _ref_grad(name, env) -> np.ndarray:
    with _x64_ctx(np.float64):
        res = _reference(name)

        def loss(u):
            (o,) = res.run({**env, "u": u}, "xla").values()
            return jnp.sum(o * jnp.asarray(_weights(o.size)))

        return np.asarray(jax.grad(loss)(jnp.asarray(env["u"])))


def _cases():
    for name in PROGRAMS:
        for path in PATHS:
            if not (name == "const" and path == "grad"):  # reads no input
                yield name, path


@pytest.mark.parametrize("name,path", list(_cases()))
def test_float64_constants_match_the_reference(name, path, monkeypatch):
    env = _env(0)
    res = _port(name)
    if path in ("torch", "auto"):
        got = res.run(env, path, device=CPU)
        assert got["o"].dtype == torch.float64
        assert rel_err(got, _ref_run(name, env)) <= PLAN64
    elif path == "run_batch":
        envs = [env, _env(1)]
        got = res.run_batch(envs, "torch", device=CPU)
        assert got["o"].dtype == torch.float64
        assert tuple(got["o"].shape) == (2, N)
        for b, e in enumerate(envs):
            assert rel_err({"o": got["o"][b]}, _ref_run(name, e)) <= PLAN64
    elif path == "run_sharded":
        mesh = make_stencil_mesh(4, ("sx", "sy"), devices=[CPU] * 4)
        if name == "const":  # no array to split: refused, as K1 refuses it
            with pytest.raises(ShardingUnavailable, match="no-base-array"):
                res.run_sharded(env, mesh, "torch")
            return
        got = res.run_sharded(env, mesh, "torch")
        assert rel_err(got, _ref_run(name, env)) <= PLAN64
    else:
        # each package's adjoint plans on its whole-array backend: the
        # reference's "auto" backward takes its Pallas kernel, whose
        # constants are float32 (ROADMAP's F0); "torch" is not a reference
        # backend name, so it is set only around the port's calls
        monkeypatch.setenv("RACE_BACKEND", "xla")
        want = _ref_grad(name, env)
        monkeypatch.setenv("RACE_BACKEND", "torch")
        u = torch.tensor(env["u"], requires_grad=True)
        (o,) = res.run({**env, "u": u}, "torch", device=CPU).values()
        (g,) = torch.autograd.grad(
            (o * torch.as_tensor(_weights(o.numel()))).sum(), u)
        assert g.dtype == torch.float64
        assert rel_err({"u": g}, {"u": want}) <= PLAN64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_constants_keep_the_outputs_dtype(name, dtype):
    """A constant is a weak scalar: a float32 or bfloat16 stream's output
    keeps its dtype.  ``o[i] = 0.1`` reads no array: its output is float32
    under either env (the reference's default mode), float64 under a
    float64 one."""
    env = {k: torch.as_tensor(v).to(getattr(torch, dtype))
           for k, v in _env(2, np.float32).items()}
    del env["o"]  # a new output: its dtype comes from the value
    if name == "twin":
        env["o"] = torch.zeros(N + 2, dtype=getattr(torch, dtype))
    got = _port(name).run(env, "torch", device=CPU)["o"]
    want = torch.float32 if name == "const" else getattr(torch, dtype)
    assert got.dtype == want
    if dtype == "float32":
        ref = {k: np.asarray(v) for k, v in _reference(name).run(
            {k: v.numpy() for k, v in env.items()}, "xla").items()}
        assert rel_err({"o": got}, ref) <= default_tolerances(
            np.float32)["plan"]
    if name == "const":
        out = _port(name).run({"u": _env(2)["u"]}, "torch", device=CPU)
        assert out["o"].dtype == torch.float64


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_log_of_a_negative_constant_is_nan_in_both_packages(backend):
    env = _env(3)
    got = _port("log_neg").run(env, backend, device=CPU)["o"]
    want = _ref_run("log_neg", env)["o"]
    assert np.isnan(want).all()
    assert torch.isnan(got).all() and got.dtype == torch.float64
