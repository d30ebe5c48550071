"""Devices, the executor and the kernel build of the PyTorch port: cuda
unless the CPU is asked for, no hidden fallback, the executor cache, the
content-addressed build and its ctypes binding, and (on a card) the kernels
against their plain versions, forward and backward.  Imports no jax, so the
``cuda`` tests run on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_device.py``."""
import ctypes
import importlib.util
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import adjoint, executor
from repro_torch.core.codegen import interior
from repro_torch.kernels import build
from repro_torch.kernels import fused_ce as fc
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


def test_digest_covers_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when any ``csrc/`` header its source includes,
    directly or through another header, changes its bytes."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    src = '#include "a.cuh"\n#include <cuda_runtime.h>\n'
    assert build.included_headers(src) == [tmp_path / "a.cuh",
                                           tmp_path / "b.cuh"]
    before = build.library_path(src)
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    assert build.library_path(src) != before
    assert build.library_path("// includes nothing\n") == build.library_path(
        "// includes nothing\n")


def test_sources_include_their_headers():
    case = get_case("j3d27pt", 12)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case), "cpu")
    ex = repro_torch.compile_plan(res.plan, env, "hopper",
                                  cache=executor.ExecutorCache())
    assert build.included_headers(ex.spec.source) == [
        build.CSRC / "race_stencil.cuh"]
    assert build.included_headers(build.csrc_source("fused_ce.cu")) == []


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_load_binds_the_symbols_it_is_given(tmp_path, monkeypatch):
    """``load`` binds each library's own C symbols; a library already in the
    build directory is loaded without nvcc (built here by gcc, standing in
    for nvcc's output)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = "long scaled(long x, int k) { return x * k; }\n"
    so = build.library_path(src)
    c = tmp_path / "scaled.c"
    c.write_text(src)
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(c)],
                   check=True)
    lib = build.load(src, {"scaled": (ctypes.c_long,
                                      [ctypes.c_long, ctypes.c_int])})
    assert lib.scaled(1 << 40, 3) == 3 << 40
    assert build.load(src, {}) is lib


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_concurrent_builds_of_one_source_stage_apart(tmp_path, monkeypatch):
    """Two threads of one process compile the same source at once (nvcc
    stood in for by a script that sleeps, then runs gcc): each stages its
    files under its own process and thread id, both finish, and the library
    is loaded once."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.delenv("RACE_COMPILE_CACHE", raising=False)
    script = tmp_path / "fake_nvcc"
    script.write_text(
        "#!/bin/sh\nsleep 0.5\n"
        'out=""; prev=""; src=""\n'
        'for a in "$@"; do\n'
        '  if [ "$prev" = "-o" ]; then out="$a"; fi\n'
        '  prev="$a"; src="$a"\n'
        "done\n"
        'exec gcc -shared -fPIC -x c -o "$out" "$src"\n')
    script.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    opened = []
    real_cdll = ctypes.CDLL

    def counting_cdll(path, *a, **kw):
        opened.append(path)
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(build.ctypes, "CDLL", counting_cdll)
    src = "int thrice(int x) { return 3 * x; }\n"
    barrier = threading.Barrier(2)
    libs, errors = [], []

    def builder():
        try:
            barrier.wait(timeout=30)
            libs.append(build.load(src, {"thrice": (ctypes.c_int,
                                                    [ctypes.c_int])}))
        except Exception as e:  # the assertion target
            errors.append(e)

    threads = [threading.Thread(target=builder) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    assert len(libs) == 2 and libs[0] is libs[1]
    assert libs[0].thrice(14) == 42
    assert opened == [str(build.library_path(src))]
    assert sorted(p.name for p in (tmp_path / "lib").iterdir()) == sorted(
        [build.library_path(src).name,
         build.library_path(src).with_suffix(".cu").name])


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


@pytest.mark.parametrize("how", ["conv1d", "mv"])
@pytest.mark.parametrize("S,C", [(64, 12), (200, 40)])
def test_smoke_tap_adjoint_library_call_computes_the_taps(S, C, how):
    """The smoke run's tap-adjoint yardsticks (one conv1d of ``sx`` with
    the output gradient as a single filter, or one matrix-vector product
    over ``sx``'s shifted rows, then 3-wide sums of the lags) give the
    mixer's tap gradients: each ``"torch"`` adjoint plan's products
    summed, at float32 within ``plan``."""
    from repro_torch.core.adjoint import adjoint_build, assemble_adjoint_env
    from repro_torch.models.ssm import _smooth_result, smooth_env

    smoke = _chip_smoke()
    R = 2
    g = torch.Generator().manual_seed(S)
    env = smooth_env(torch.randn((2, S, C // 2), generator=g),
                     torch.randn(R + 1, generator=g), R)
    gy = {"sy": torch.randn(env["sy"].shape, generator=g)}
    res = _smooth_result(S, C, R)
    want, adj = [], None
    for spec in adjoint_build(res.program).specs:
        if spec.input.startswith("sw"):
            adj = assemble_adjoint_env(spec, env, gy)
            ex = repro_torch.compile_plan(spec.result().plan, adj, "torch")
            want.append((int(spec.input[2:]), ex(adj)[spec.gu].sum()))
    assert [d for d, _ in sorted(want)] == list(range(R + 1))
    got = smoke.tap_adjoint_library_call(adj, R, torch, how)()
    assert got.shape == (R + 1,) and got.dtype == torch.float32
    assert rel_err({"sw": got}, {"sw": torch.stack(
        [v for _, v in sorted(want)])}) <= default_tolerances(
            np.float32)["plan"]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_kernel_matches_plain_on_card(cuda_device, dtype):
    """Kernel vs its plain version on the card, f32 sums on both sides in
    another order: 1e-5 of the largest loss.  float32 takes the 3xTF32
    kernel at every shape (D = 37 included: its pre-pass pads); bf16 takes
    the tensor-core kernel where TMA can load it (T, D and V no multiple of
    its 128 x 256 x 64 tile in the last shapes) and the FFMA kernel at V =
    100 and D = 37; the launch count of the variant that ran rises by
    one."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for T, D, V, v_blk in [(64, 32, 256, 64), (32, 16, 100, 25),
                           (48, 64, 512, 512), (100, 40, 1000, None),
                           (200, 96, 1000, None), (300, 136, 4104, None),
                           (128, 64, 4096, 512), (72, 37, 515, None)]:
        h = torch.randn(T, D, generator=gen, device=cuda_device).to(dtype)
        w = (torch.randn(D, V, generator=gen, device=cuda_device)
             * 0.05).to(dtype)
        labels = torch.randint(0, V, (T,), generator=gen, device=cuda_device,
                               dtype=torch.int32)
        labels[0] = V  # out of range: gold logit 0
        kind = fc.variant(h, w)
        if dtype == torch.float32:
            assert kind == "tf32x3"
        else:
            assert kind == ("ffma" if V == 100 or D == 37 else "wgmma")
        before = fc.KERNEL.launches
        by_variant = dict(fc.KERNEL.launches_by_variant)
        got = fc.fused_ce_forward(h, w, labels, v_blk=v_blk)
        assert fc.KERNEL.launches == before + 1
        assert fc.KERNEL.launches_by_variant[kind] == by_variant[kind] + 1
        want = fc.fused_ce_forward_ref(h, w, labels, v_blk=v_blk)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_tf32_split_kernel_matches_plain_bit_for_bit(cuda_device, transpose):
    """The 3xTF32 pre-pass against its plain version on a ragged shape
    (neither side a multiple of the kernel's 32 x 32 tile or of 4), with
    signed zeros, a tie, a subnormal and infinities among the values."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(37, 515, generator=gen, device=cuda_device) * 3
    x.view(-1)[:7] = torch.tensor([0.0, -0.0, 1 + 2 ** -11, 2.0 ** -130
                                   + 2.0 ** -137 + 2.0 ** -149,
                                   float("inf"), float("-inf"), -1e-3])
    before = fc.KERNEL.split_launches
    got = fc.tf32_split(x, transpose)
    assert fc.KERNEL.split_launches == before + 1
    want = fc.tf32_split_ref(x, transpose)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_grad_through_run_launches_the_kernel_in_backward(cuda_device):
    """``torch.autograd.grad`` through ``res.run`` on the card: the adjoint
    plans the probe admits run on the Hopper kernel (the array specs', and
    the four scalars' as one group), each launched once, and the gradients
    match autograd of the float64 baseline within ``grad``."""
    case = get_case("psinv", 16)
    res = repro_torch.race(case.program, reassociate=3)
    env = env_to_torch(build_env(case), cuda_device)
    keys = ["R", "U", "w0", "w1", "w2", "w3"]
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p})
    g = {k: torch.cos(torch.arange(v.numel(), device=cuda_device,
                                   dtype=v.dtype)).reshape(v.shape)
         for k, v in out.items()}
    build_ = adjoint.adjoint_build(case.program)
    units = adjoint.adjoint_runs(build_, env, g, keys)
    assert [type(u).__name__ for u in units] == [
        "InputSpec", "InputSpec", "ScalarGroup"]
    adj = [repro_torch.compile_plan(
        u.result().plan, adjoint.assemble_adjoint_env(u, env, g))
        for u in units]
    assert all(ex.backend == "hopper" for ex in adj)
    before = [ex.kernel_launches for ex in adj]
    grads = torch.autograd.grad([out[k] for k in g], [p[k] for k in keys],
                                [g[k] for k in g])
    torch.cuda.synchronize()
    assert [ex.kernel_launches - b for ex, b in zip(adj, before)] == [1] * len(
        adj)
    env64 = {k: v.double().requires_grad_() for k, v in env.items()}
    base = interior(res.plan, res.baseline_evaluator()(env64))
    want = torch.autograd.grad([base[k] for k in g], [env64[k] for k in keys],
                               [g[k].double() for k in g])
    tol = default_tolerances(np.float32)["grad"]
    assert rel_err(dict(zip(keys, grads)), dict(zip(keys, want))) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_run_batch_on_card_is_one_launch_equal_to_run(cuda_device, dt):
    """``run_batch`` on the card: one K1 launch for the batch (the examples
    on ``blockIdx.y``, per-example scalars), each example bit for bit
    ``run`` of it (the same schedule), the batch the ``"torch"`` batched
    evaluator within ``plan``."""
    case = get_case("j3d27pt", 2 * SWEEP_SIZES["j3d27pt"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    envs = [build_env(case, dt, seed=s) for s in range(3)]
    stacked = executor.stack_envs(envs, cuda_device)
    ex = repro_torch.compile_plan(res.plan,
                                  executor.stacked_signature(stacked),
                                  "hopper", device=cuda_device)
    before = ex.kernel_launches
    got = res.run_batch(stacked, "hopper")
    assert ex.kernel_launches == before + 1
    for b in range(3):
        example = {k: v[b] for k, v in stacked.items()}
        per = res.run(example, "hopper")
        assert torch.equal(got["j27"][b], per["j27"])
    # run and run_batch share the executor: the batch's launch and the
    # three single ones are all its own
    assert repro_torch.compile_plan(res.plan, example, "hopper") is ex
    assert ex.kernel_launches == before + 4
    want = res.run_batch(stacked, "torch")
    torch.cuda.synchronize()
    assert rel_err(got, want) <= default_tolerances(dt)["plan"]


@pytest.mark.cuda
def test_output_dtype_on_card_follows_the_env_output_array(cuda_device):
    case = get_case("hdifft_gm", 2 * SWEEP_SIZES["hdifft_gm"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    outs = {st.lhs.name for st in case.program.body}
    env = {k: (v.astype(np.float64) if k in outs else v)
           for k, v in build_env(case).items()}
    got = res.run(env, "hopper")
    want = res.run(env, "torch")
    torch.cuda.synchronize()
    assert {v.dtype for v in got.values()} == {torch.float64}
    assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]


@pytest.mark.cuda
def test_batched_grad_launches_each_adjoint_kernel_once(cuda_device):
    """``torch.autograd.grad`` through ``run_batch``: each adjoint run's
    kernel (``u``'s, and the five scalars' group) launches once for the
    whole batch, and each example's gradient equals ``run``'s within
    ``grad``."""
    case = get_case("j3d27pt", 2 * SWEEP_SIZES["j3d27pt"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    stacked = executor.stack_envs([build_env(case, seed=s) for s in range(3)],
                                  cuda_device)
    stacked.pop("j27")
    keys = sorted(stacked)
    p = {k: stacked[k].clone().requires_grad_() for k in keys}
    out = res.run_batch(p)
    g = {k: torch.cos(torch.arange(v.numel(), device=cuda_device,
                                   dtype=v.dtype)).reshape(v.shape)
         for k, v in out.items()}
    adj = []
    units = adjoint.adjoint_runs(adjoint.adjoint_build(case.program),
                                 stacked, g, keys)
    assert [type(u).__name__ for u in units] == ["InputSpec", "ScalarGroup"]
    for u in units:
        a = adjoint.assemble_adjoint_env(u, stacked, g)
        adj.append(repro_torch.compile_plan(
            u.result().plan, executor.stacked_signature(a),
            device=cuda_device))
    assert all(ex.backend == "hopper" for ex in adj)
    before = [ex.kernel_launches for ex in adj]
    grads = torch.autograd.grad([out[k] for k in g], [p[k] for k in keys],
                                [g[k] for k in g])
    torch.cuda.synchronize()
    assert [ex.kernel_launches - b for ex, b in zip(adj, before)] == [1] * len(
        adj)
    tol = default_tolerances(np.float32)["grad"]
    for b in range(3):
        q = {k: stacked[k][b].clone().requires_grad_() for k in keys}
        o = res.run(q)
        want = torch.autograd.grad([o[k] for k in g], [q[k] for k in keys],
                                   [g[k][b] for k in g])
        assert rel_err({k: x[b] for k, x in zip(keys, grads)},
                       dict(zip(keys, want))) <= tol


@pytest.mark.cuda
def test_hvp_launches_the_kernel_in_the_second_backward(cuda_device):
    """A Hessian-vector product through ``res.run`` on the card: every
    executor of the second backward is K1's, the J^T step (the forward's
    adjoint) and the J v step (the adjoint of that adjoint) each launch,
    and the product equals plain autograd of the ``"torch"`` evaluator
    within ``grad``."""
    case = get_case("j3d27pt", 2 * SWEEP_SIZES["j3d27pt"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = env_to_torch(build_env(case), cuda_device)
    env.pop("j27")
    v = torch.cos(torch.arange(env["u"].numel(), device=cuda_device,
                               dtype=env["u"].dtype)).reshape(env["u"].shape)
    from repro_torch.core.codegen import build_plan_evaluator

    plan_run = build_plan_evaluator(res.plan)

    def first(run):
        u = env["u"].clone().requires_grad_()
        out = run({**env, "u": u})
        (g,) = torch.autograd.grad(sum((o * o).sum() for o in out.values()),
                                   u, create_graph=True)
        return u, g

    u, g = first(res.run)
    spec = adjoint.adjoint_build(case.program).spec_for("u")
    spec2 = adjoint.adjoint_build(spec.program).spec_for(
        adjoint.COTANGENT_PREFIX + "j27")
    cache = executor.executor_cache()
    before = {id(ex): (ex.calls, ex.kernel_launches)
              for ex in cache.executors()}
    (h,) = torch.autograd.grad(g, u, v)
    torch.cuda.synchronize()
    ran = [ex for ex in cache.executors()
           if ex.calls > before.get(id(ex), (0, 0))[0]]
    assert {ex.backend for ex in ran} == {"hopper"}
    launched = {repro_torch.plan_hash(ex.plan) for ex in ran
                if ex.kernel_launches > before.get(id(ex), (0, 0))[1]}
    assert {repro_torch.plan_hash(s.result().plan)
            for s in (spec, spec2)} <= launched
    u2, g2 = first(lambda e: interior(res.plan, plan_run(e)))
    (want,) = torch.autograd.grad(g2, u2, v)
    torch.cuda.synchronize()
    assert rel_err({"u": h}, {"u": want}) <= default_tolerances(
        np.float32)["grad"]


@pytest.mark.cuda
def test_autotune_on_card_gates_times_and_is_reused(cuda_device):
    """``autotune`` on the card: every tile candidate is built before it is
    timed, the winner passed the gate and is not slower than the default
    beyond the noise margin, a second call answers from the store, and
    ``"auto"`` then builds the executor with the record's blocks."""
    from repro_torch.tuning import autotune, record_key, runtime_fence

    case = get_case("j3d27pt", 4 * SWEEP_SIZES["j3d27pt"])
    env = {k: v for k, v in build_env(case).items() if k != "j27"}
    lvl = case.reassociate
    dec = autotune(case.program, env, levels=(lvl,), default_reassociate=lvl,
                   repeats=3, warmup=1)
    assert any(m.config == dec.choice and m.ok for m in dec.measurements)
    assert dec.tuned_us <= dec.default_us
    assert all(m.status != "error" or "tile-extent" in m.detail
               for m in dec.measurements)
    assert autotune(case.program, env, levels=(lvl,),
                    default_reassociate=lvl, repeats=3,
                    warmup=1).from_cache
    res = repro_torch.race(case.program, reassociate=lvl)
    tenv = env_to_torch(env, cuda_device)
    ex = repro_torch.compile_plan(res.plan, tenv)
    assert ex.backend == dec.choice.backend
    if ex.backend == "hopper":
        forced = repro_torch.compile_plan(
            res.plan, tenv, "hopper", block_rows=dec.choice.block_rows,
            block_cols=dec.choice.block_cols,
            block_inner=dec.choice.block_inner)
        assert forced is ex
    got = res.run(tenv)
    torch.cuda.synchronize()
    assert rel_err(got, res.run(tenv, "torch")) <= default_tolerances(
        np.float32)["plan"]


@pytest.mark.cuda
def test_serve_runtime_on_card_launches_once_per_batch(cuda_device):
    """``ServeRuntime`` on the card (its default device): each response is
    bit-equal to ``run`` of its env, and K1 launches once per dispatch."""
    from repro_torch.serve import ServeRuntime

    case = get_case("j3d27pt", 2 * SWEEP_SIZES["j3d27pt"])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    envs = [{k: v for k, v in build_env(case, seed=s).items() if k != "j27"}
            for s in range(6)]
    ex = repro_torch.compile_plan(res.plan, env_to_torch(envs[0],
                                                         cuda_device))
    assert ex.backend == "hopper"
    before = ex.kernel_launches
    with ServeRuntime(max_batch=4, window_us=50000, workers=1) as rt:
        got = [f.result(timeout=120) for f in rt.submit_many(res, envs)]
        stats = rt.stats()
    assert stats["batches"] == 2 and stats["rejected"] == 0
    assert ex.kernel_launches - before == stats["batches"]
    for env, g in zip(envs, got):
        want = res.run(env)
        assert all(np.array_equal(g[k], want[k].cpu().numpy()) for k in want)


@pytest.mark.cuda
def test_run_sharded_on_one_card_launches_k1_per_shard(cuda_device):
    """A 2x2 mesh of one card repeated: ``run_sharded`` on ``"hopper"``
    launches K1 once per shard (4 per call, on one local executor) and
    matches the single-device ``run`` within ``plan``, for both halo
    strategies."""
    from repro_torch.launch.mesh import make_stencil_mesh
    from repro_torch.shard import compile_sharded

    case = get_case("poisson", 4 * SWEEP_SIZES["poisson"] + 2)
    res = repro_torch.race(case.program, reassociate=case.reassociate,
                           backend="hopper")
    env = env_to_torch(build_env(case), cuda_device)
    mesh = make_stencil_mesh(devices=[cuda_device] * 4)
    want = res.run(env)
    for halo in ("exchange", "recompute"):
        sr = compile_sharded(res, env, mesh, halo=halo, backend="hopper")
        assert sr.backend == "hopper" and len(sr.locals) == 1
        before = sr.kernel_launches
        got = res.run_sharded(env, mesh, halo=halo)
        torch.cuda.synchronize()
        assert sr.kernel_launches - before == 4
        assert {t.device for t in got.values()} == {env["u"].device}
        assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]


@pytest.mark.cuda
def test_run_sharded_over_two_cards():
    """A 2-shard mesh over ``cuda:0`` and ``cuda:1``: each shard's K1
    launches on its own card, the halo crosses between them, and the
    outputs on ``cuda:0`` match the single-device ``run``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.launch.mesh import make_stencil_mesh
    from repro_torch.shard import compile_sharded

    case = get_case("poisson", 4 * SWEEP_SIZES["poisson"] + 2)
    res = repro_torch.race(case.program, reassociate=case.reassociate,
                           backend="hopper")
    env = env_to_torch(build_env(case), "cuda:0")
    mesh = make_stencil_mesh(2)
    want = res.run(env)
    sr = compile_sharded(res, env, mesh, halo="exchange", backend="hopper")
    assert sorted(sr.locals) == ["cuda:0", "cuda:1"]
    before = {d: ex.kernel_launches for d, ex in sr.locals.items()}
    got = res.run_sharded(env, mesh, halo="exchange")
    for i in range(2):
        torch.cuda.synchronize(i)
    assert {d: ex.kernel_launches - before[d]
            for d, ex in sr.locals.items()} == {"cuda:0": 1, "cuda:1": 1}
    assert {t.device for t in got.values()} == {torch.device("cuda:0")}
    assert rel_err(got, want) <= default_tolerances(np.float32)["plan"]


@pytest.mark.cuda
def test_race_smooth_on_card_is_k1_within_plan_of_torch(cuda_device):
    """The LM's RACE mixer on a CUDA stream: ``"auto"`` is K1 (one launch
    a call) and agrees with the ``"torch"`` evaluator within ``plan``."""
    from repro_torch.models import ssm

    g = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn(2, 48, 96, generator=g, device=cuda_device)
    taps = torch.randn(3, generator=g, device=cuda_device)
    env = ssm.smooth_env(x, taps, 2)
    res = ssm._smooth_result(48, 2 * 96, 2)
    ex = repro_torch.compile_plan(res.plan, env)
    assert ex.backend == "hopper"
    before = ex.kernel_launches
    got = ssm.race_smooth(x, taps, radius=2)
    assert ex.kernel_launches == before + 1
    want = ssm.race_smooth(x, taps, radius=2, backend="torch")
    torch.cuda.synchronize()
    assert rel_err({"y": got}, {"y": want}) <= default_tolerances(
        np.float32)["plan"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_summed_tap_adjoints_on_card(cuda_device, dt):
    """The mixer's tap adjoints through ``run_sum`` on a CUDA stream: the
    summed kernel launches once, writes one partial per block (and
    ``(2, n_tiles)`` for a batch of two), and their sums agree with the
    ``"torch"`` plan's products within ``plan`` of ``sum |g b|``."""
    from repro_torch.models import ssm

    g = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn(2, 48, 96, generator=g, device=cuda_device, dtype=dt)
    env = ssm.smooth_env(x, torch.randn(3, generator=g, device=cuda_device),
                         2)
    env = {k: v.to(dt) for k, v in env.items()}
    gy = {"sy": torch.randn(env["sy"].shape, generator=g,
                            device=cuda_device, dtype=dt)}
    res = ssm._smooth_result(48, 2 * 96, 2)
    tol = default_tolerances(dt)["plan"]
    for spec in adjoint.adjoint_build(res.program).specs:
        if not spec.scalar:
            continue
        a = adjoint.assemble_adjoint_env(spec, env, gy)
        ex = repro_torch.compile_plan(spec.result().plan, a, "hopper")
        full = repro_torch.compile_plan(spec.result().plan, a, "torch")(a)[
            spec.gu].double()
        before = ex.kernel_launches
        parts = ex.run_sum(a)[spec.gu]
        assert ex.kernel_launches == before + 1
        assert parts.shape == (ex.spec.tp.geometry.n_tiles,)
        batch = ex.run_sum({k: torch.stack([v, v]) for k, v in a.items()},
                           batched=True)[spec.gu]
        assert batch.shape == (2, ex.spec.program(2).geometry.n_tiles)
        torch.cuda.synchronize()
        scale = float(full.abs().sum())
        for got in (parts, batch[0], batch[1]):
            assert abs(float(got.double().sum() - full.sum())) <= (
                tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["j3d27pt", "poisson"])
def test_scalar_group_on_card_is_one_summed_launch(cuda_device, name):
    """A backward through ``res.run`` on the card runs the scalars as one
    group: one summed K1 launch, whose members' gradients equal their own
    summed launches' within ``plan``."""
    case = get_case(name, 2 * SWEEP_SIZES[name])
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = env_to_torch(build_env(case), cuda_device)
    outs = {st.lhs.name for st in case.program.body}
    keys = sorted(k for k in env if k not in outs)
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p})
    g = {k: torch.cos(torch.arange(v.numel(), device=cuda_device,
                                   dtype=v.dtype)).reshape(v.shape)
         for k, v in out.items()}
    build_ = adjoint.adjoint_build(case.program)
    group = build_.scalar_group(keys)
    a = adjoint.assemble_adjoint_env(group, env, g)
    ex = repro_torch.compile_plan(group.result().plan, a)
    assert ex.backend == "hopper"
    before = ex.kernel_launches
    grads = dict(zip(keys, torch.autograd.grad(
        [out[k] for k in g], [p[k] for k in keys], [g[k] for k in g])))
    torch.cuda.synchronize()
    assert ex.kernel_launches == before + 1
    own = {}
    for m in group.members:
        own.update(adjoint._run_unit(m, env, g))
    assert rel_err({k: grads[k] for k in own}, own) <= default_tolerances(
        np.float32)["plan"]


@pytest.mark.cuda
def test_reduced_lm_prefill_and_decode_on_card(cuda_device):
    """qwen2's reduced config with the mixer, float32 on the card: the
    prefill launches K1 once and matches the same model on the CPU; a
    decode step is finite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (ExecConfig, decode_step, init_caches,
                                    init_params, prefill_logits)

    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                              dtype="float32", race_smooth_radius=2)
    model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    with torch.no_grad():
        model.smooth_taps.copy_(torch.tensor([0.3, -0.2, 0.1]))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    exec_cfg = ExecConfig(attn_chunk_q=8, attn_chunk_k=8)
    want = prefill_logits(model, cfg, exec_cfg, {"tokens": tokens})
    model = model.to(cuda_device)
    from repro_torch.models import ssm

    res = ssm._smooth_result(16, 2 * cfg.d_model, 2)
    env = ssm.smooth_env(model.embed[torch.as_tensor(tokens,
                                                     device=cuda_device)],
                         model.smooth_taps, 2)
    ex = repro_torch.compile_plan(res.plan, env)
    before = ex.kernel_launches
    got = prefill_logits(model, cfg, exec_cfg, {"tokens": tokens})
    assert ex.kernel_launches == before + 1
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    caches = init_caches(cfg, 2, 16)
    logits, _ = decode_step(model, caches, cfg, exec_cfg, tokens[:, :1], 0,
                            max_len=16)
    assert bool(torch.isfinite(logits).all())


def test_launch_train_asks_for_cuda_and_raises_without_a_card(monkeypatch,
                                                              tmp_path):
    """``launch.train`` without ``--device`` trains on ``cuda``; with no
    card it raises before building anything: no quiet CPU run."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train.parser().parse_args(["--arch", "qwen2_7b", "--reduced",
                                      "--ckpt-dir", str(tmp_path)])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.setup(args)


@pytest.mark.cuda
def test_train_step_on_card_runs_the_mixer_and_its_adjoints_on_k1(
        cuda_device):
    """One train step of qwen2's reduced config with the mixer, float32 on
    the card: the forward and every adjoint run (``sx``'s, and the three
    taps' group) are K1 executors that launched once, the loss matches the
    same step on the CPU within 1e-5."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.executor import executor_cache
    from repro_torch.models import ExecConfig, init_params, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                              dtype="float32", race_smooth_radius=2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    exec_cfg = ExecConfig(attn_chunk_q=8, attn_chunk_k=8, loss_chunk=8)
    losses = {}
    for dev in ("cpu", cuda_device):
        model = init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", trainable=True).to(dev)
        with torch.no_grad():
            model.smooth_taps.copy_(torch.tensor([0.3, -0.2, 0.1]))
        opt_cfg = AdamWConfig(lr=1e-3)
        executor_cache().clear()
        _, _, m = make_train_step(cfg, opt_cfg, exec_cfg)(
            model, adamw_init(model, opt_cfg), batch)
        losses[str(dev)] = float(m["loss"])
    exs = executor_cache().executors()
    assert len(exs) == 3
    assert {ex.backend for ex in exs} == {"hopper"}
    assert all(ex.kernel_launches == 1 for ex in exs)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
