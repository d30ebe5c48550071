"""Devices and the executor of the PyTorch port: cuda unless the CPU is
asked for, no hidden fallback, the executor cache, and (on a card) the
kernel against the torch evaluator.  Imports no jax, so the ``cuda`` test
runs on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_device.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import executor
from repro_torch.kernels import build
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err)

pytestmark = pytest.mark.port


@pytest.fixture
def case_res():
    case = get_case("j3d27pt", 12)
    return case, repro_torch.race(case.program, reassociate=3)


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
def test_run_without_device_raises_without_gpu(case_res, monkeypatch,
                                               backend):
    """No device named means cuda; with no GPU that raises before anything
    is specialized or computed on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case, res = case_res
    cache = executor.executor_cache()
    before = cache.stats_snapshot()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        res.run(build_env(case), backend)
    assert cache.stats_snapshot() == before


@pytest.mark.parametrize("backend", ["torch", "hopper", "auto"])
def test_cpu_device_runs_when_asked(case_res, backend):
    case, res = case_res
    out = res.run(build_env(case), backend, device="cpu")
    assert {t.device.type for t in out.values()} == {"cpu"}
    assert tuple(out["j27"].shape) == (10, 10, 10)


def test_executor_cache_hits_on_same_signature(case_res):
    case, res = case_res
    cache = executor.ExecutorCache()
    env = env_to_torch(build_env(case), "cpu")
    ex1 = repro_torch.compile_plan(res.plan, env, "hopper", cache=cache)
    before = cache.stats_snapshot()
    ex2 = repro_torch.compile_plan(res.plan, env, "hopper", cache=cache)
    after = cache.stats_snapshot()
    assert ex2 is ex1
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    env64 = env_to_torch(build_env(case, np.float64), "cpu")
    assert repro_torch.compile_plan(res.plan, env64, "hopper",
                                    cache=cache) is not ex1
    assert repro_torch.compile_plan(res.plan, env, "torch",
                                    cache=cache) is not ex1
    ex1.run(env)
    assert ex1.calls == 1 and ex1.kernel_launches == 0  # emulated, no card


def test_auto_selects_hopper_and_records_probe(case_res):
    case, res = case_res
    env = env_to_torch(build_env(case), "cpu")
    ex = repro_torch.compile_plan(res.plan, env, "auto",
                                  cache=executor.ExecutorCache())
    assert ex.backend == "hopper" and ex.selection.requested == "auto"
    assert ex.selection.capability.eligible and not ex.selection.fell_back
    with pytest.raises(ValueError, match="unknown backend"):
        repro_torch.compile_plan(res.plan, env, "pallas")


def test_env_signature_has_no_weak_type_flag(case_res):
    case, _ = case_res
    sig = repro_torch.env_signature(env_to_torch(build_env(case), "cpu"))
    assert all(len(entry) == 3 for entry in sig)
    assert dict((n, d) for n, _, d in sig)["u"] == "float32"
    assert dict((n, s) for n, s, _ in sig)["jc0"] == ()


def test_torch_backend_leaves_caller_tensors_alone():
    """An output that is also in env is cloned before it is written."""
    case = get_case("hdifft_gm", 14)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case), "cpu")
    saved = {k: v.clone() for k, v in env.items()}
    res.run(env, "torch", device="cpu")
    for k, v in env.items():
        assert torch.equal(v, saved[k]), k


def test_kernel_library_is_content_addressed():
    a = build.library_path("// a\n")
    assert a == build.library_path("// a\n")
    assert a != build.library_path("// b\n")
    assert a.parent == build.BUILD_DIR and a.suffix == ".so"


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_smoke_library_call_computes_j3d27pt(dt):
    """The smoke run's library yardstick (one conv3d) computes the same
    function as the plan, within the ``baseline`` tolerance."""
    smoke = _chip_smoke()
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = env_to_torch(build_env(case, dt), "cpu")
    got = smoke.library_call(case, env)()
    want = res.run(env, "torch", device="cpu")
    assert got["j27"].shape == want["j27"].shape
    assert rel_err(got, want) <= default_tolerances(dt)["baseline"]
    assert smoke.library_call(get_case("poisson", 10), env) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["j3d27pt", "rprj3", "blocked4d",
                                  "mirror_deriv", "diag2d"])
def test_kernel_matches_torch_on_card(cuda_device, name):
    case = get_case(name, 2 * SWEEP_SIZES[name])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    for dt in (np.float32, np.float64):
        env = env_to_torch(build_env(case, dt), cuda_device)
        ex = repro_torch.compile_plan(res.plan, env, "hopper")
        before = ex.kernel_launches
        got = res.run(env, "hopper")
        assert ex.kernel_launches == before + 1
        want = res.run(env, "torch")
        torch.cuda.synchronize()
        assert rel_err(got, want) <= default_tolerances(dt)["plan"]


@pytest.mark.cuda
def test_kernel_launches_on_its_operands_device():
    """Operands on the second card while the first is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    case = get_case("j3d27pt", 2 * SWEEP_SIZES["j3d27pt"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = env_to_torch(build_env(case), "cuda:1")
    with torch.cuda.device(0):
        got = res.run(env, "hopper", device="cuda:1")
        want = res.run(env, "torch", device="cuda:1")
    torch.cuda.synchronize(1)
    assert {t.device for t in got.values()} == {torch.device("cuda:1")}
    assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]
