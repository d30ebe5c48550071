"""K1 at float16 and bfloat16: the stencil kernel's emulator and the
``"torch"`` evaluator against the reference's ``"xla"`` on the same bits,
the probe's selection and refusals, the half source's text (nvcc is absent
here) and float16 gradients against the reference's ``jax.grad``.

numpy has no bfloat16, so a bfloat16 env is the float32 ``build_env``
rounded to nearest even on both sides (``jnp.bfloat16``, ``torch.bfloat16``);
the test checks that both packages see the same bits."""
import hashlib
import re

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core.race import race as ref_race

import repro_torch
from repro_torch.apps import get_case
from repro_torch.apps.paper_kernels import pop_hdifft_gm
from repro_torch.core import backend as backend_mod
from repro_torch.core import executor
from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
from repro_torch.core.backend import probe_hopper
from repro_torch.core.codegen import required_shapes
from repro_torch.kernels.build import CSRC, included_headers
from repro_torch.lowering import R_HOPPER_DTYPE
from repro_torch.lowering.emit import (KERNEL_DTYPES, specialize_stencil,
                                       tile_program)
from repro_torch.serve import ServeRuntime
from repro_torch.testing import (SWEEP_SIZES, build_env, default_tolerances,
                                 env_to_torch, rel_err, torch_env)
from repro_torch.tuning import candidate_configs

pytestmark = pytest.mark.port

HALF = {"float16": (torch.float16, jnp.float16),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _envs(pc, dtype: str, seed: int = 0):
    """(the reference's env, the port's CPU env): the same bits."""
    if dtype == "float16":
        env = build_env(pc, np.float16, seed)
        ref = env
    else:
        ref = {k: jnp.asarray(v).astype(jnp.bfloat16)
               for k, v in build_env(pc, np.float32, seed).items()}
    port = torch_env(pc, dtype, seed, device="cpu")
    for k, v in ref.items():
        bits = np.asarray(v).view(np.uint16)
        assert np.array_equal(bits, port[k].view(torch.int16).numpy()
                              .view(np.uint16))
    return ref, port


def _ref_xla(rc, lvl, env) -> dict:
    res = ref_race(rc.program, reassociate=lvl, rewrite_div=rc.rewrite_div)
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in res.run(env, "xla").items()}


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_registry_against_reference_xla(name, which, dtype):
    """Every case at its sweep size: ``"auto"`` selects the kernel, and the
    kernel's emulator (float computed, rounded once) and the ``"torch"``
    evaluator (op by op in the half dtype) lie within the dtype's ``plan``
    row of the reference's ``"xla"`` (op by op in the half dtype)."""
    n = SWEEP_SIZES[name]
    rc, pc = ref_case(name, n), get_case(name, n)
    lvl = 0 if which == "r0" else rc.reassociate
    ref_env, env = _envs(pc, dtype)
    want = _ref_xla(rc, lvl, ref_env)
    res = repro_torch.race(pc.program, reassociate=lvl,
                           rewrite_div=pc.rewrite_div)
    assert repro_torch.compile_plan(res.plan, env, "auto").backend == "hopper"
    tol = default_tolerances(dtype)["plan"]
    for backend in ("hopper", "torch"):
        got = res.run(env, backend, device="cpu")
        assert {v.dtype for v in got.values()} == {HALF[dtype][0]}
        assert rel_err(got, want) <= tol, backend


@pytest.mark.parametrize("dtype", list(HALF))
def test_auto_selects_the_kernel_and_run_batch_launches_it(dtype):
    """``"auto"`` selects ``"hopper"`` for a half env; ``run_batch`` takes
    the kernel's batch path, every example bit-equal to ``run``."""
    case = get_case("j3d27pt", 10)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    envs = [torch_env(case, dtype, seed, device="cpu") for seed in (0, 1, 2)]
    ex = repro_torch.compile_plan(res.plan, envs[0], "auto")
    assert ex.backend == "hopper" and ex.selection.capability.eligible
    got = res.run_batch(envs, device="cpu")
    for b, env in enumerate(envs):
        one = res.run(env, device="cpu")
        for k, v in one.items():
            assert v.dtype == HALF[dtype][0]
            assert torch.equal(got[k][b], v)


@pytest.mark.parametrize("dtypes", [("float16", "float32"),
                                    ("bfloat16", "float16"), ("int32",),
                                    ("float16", "int32")])
def test_mixed_and_integer_dtypes_keep_hopper_dtype(dtypes):
    case = get_case("hdifft_gm", 14)
    res = repro_torch.race(case.program, reassociate=3)
    cap = probe_hopper(res.plan, dtypes)
    assert not cap.eligible
    assert [r.code for r in cap.reasons] == [R_HOPPER_DTYPE]
    assert probe_hopper(res.plan, [dtypes[0]] * 2).eligible == (
        dtypes[0] in KERNEL_DTYPES)


def _without_staging(src: str) -> str:
    """``src`` with the staging of its operands' later planes taken out:
    at 4 and 8 bytes ``cp.async``'s commits, its wait and its next-plane
    block; at 2 bytes the registers' comments and declarations and the
    next-plane load and store blocks.  What stays (the first plane's
    staging included) is what a half kernel shares with the float32
    kernel of its plan."""
    out, depth = [], 0
    for line in src.split("\n"):
        if depth:
            depth += line.count("{") - line.count("}")
            continue
        if line.startswith("    if (k + 1 < ") and line.endswith(") {"):
            depth = 1
            continue
        if line.strip() in ("race_cp_async_commit();",
                            "race_cp_async_wait<0>();") or line.startswith(
                ("    // the next step's planes", "    // body: the loads",
                 "    store_t h", "    int a")):
            continue
        out.append(line)
    return "\n".join(out)


@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_half_geometry_is_the_float32_geometry(name, which):
    """Shared memory holds float for both half types, so a half plan's
    geometry and shared bytes equal the float32 plan's; its source differs
    only in the types the kernel is instantiated for and in how the
    operands' later planes are staged (through registers across the step
    at 2 bytes, by ``cp.async`` at 4)."""
    case = get_case(name, SWEEP_SIZES[name])
    lvl = 0 if which == "r0" else case.reassociate
    res = repro_torch.race(case.program, reassociate=lvl,
                           rewrite_div=case.rewrite_div)
    shapes = required_shapes(case.program)
    tps = {dt: tile_program(res.plan, shapes, {k: dt for k in shapes})
           for dt in ("float32", "float16", "bfloat16")}
    for dt in ("float16", "bfloat16"):
        assert tps[dt].geometry == tps["float32"].geometry
        assert tps[dt].smem_bytes == tps["float32"].smem_bytes == (
            tps[dt].smem_elems * 4)
    srcs = {dt: specialize_stencil(res.plan, shapes, {k: dt for k in shapes})
            .source for dt in tps}
    f32 = _without_staging(srcs["float32"]).replace(
        "if (dtype == 0) return launch<float, float>(", "")
    staged = any(r.operand for r in tps["float32"].geometry.rings)
    for dt, src in srcs.items():
        kd = KERNEL_DTYPES[dt]
        code = list(KERNEL_DTYPES).index(dt)
        inst = (f"if (dtype == {code}) return launch<{kd.storage}, "
                f"{kd.acc}>(")
        assert inst in src
        assert _without_staging(src).replace(inst, "") == f32.replace(
            "race_stencil.cuh", kd.header)
        if dt != "float32":  # the staging itself differs where there is one
            assert (src.replace(inst, "") != srcs["float32"].replace(
                "if (dtype == 0) return launch<float, float>(", "").replace(
                "race_stencil.cuh", kd.header)) == staged


#: (case, n) of phase 4's float32 and float64 cells and the sha256 of each
#: one's rendered source (``specialize_stencil(...).source``) as the march
#: step renders it since its redesign (fixed thread maps, one barrier a
#: phase, launch bounds), the sources timed on the card beside their
#: parents: the float32 and float64 kernels change only with a step
#: measured there
F32_F64_SOURCES = {
    ("j3d27pt", 512, "float32"):
        "3b14d3cd9ea42cb133123ede2b36b604ec8b2d499543d376e2ec8fc870f407ed",
    ("poisson", 512, "float32"):
        "cd5725033cd18d198511a00236bd2b0f1bcea063f7cb18dbf539309f700e5602",
    ("derivative", 256, "float64"):
        "e4d1a7b09be95fc2ee3b66ce3da1372a4d5f50647375a4cc71ab30f3508d83f9",
    ("hdifft_gm", 8192, "float32"):
        "b6f0c0857f21f19cc178155bf822811cdc928d8f6822e926e3770698ee170a9b",
    # the summed kernel of j3d27pt n=64's adjoint of its scalar jc1, float32
    ("j3d27pt:jc1", 64, "float32"):
        "bdc05296039929aa46a5589d7e67f2a8475e591449b5dc13108bf3e17051b937",
}


def _phase4_case(name: str, n: int):
    return pop_hdifft_gm(n, n) if name == "hdifft_gm" else get_case(name, n)


@pytest.mark.parametrize("name,n,dtype", list(F32_F64_SOURCES))
def test_float32_and_float64_sources_are_unchanged(name, n, dtype):
    name, _, scalar = name.partition(":")
    case = _phase4_case(name, n)
    shapes = required_shapes(case.program)
    if scalar:
        spec = next(s for s in adjoint_build(case.program).specs
                    if s.input == scalar)
        assert spec.scalar
        adj = adjoint_env_shapes(spec, case.program, shapes)
        src = specialize_stencil(spec.result().plan, adj, {
            k: dtype for k in adj}).source_for(1, summed=True)
        assert "race_block_sum(" in src
    else:
        res = repro_torch.race(case.program, reassociate=case.reassociate)
        src = specialize_stencil(res.plan, shapes,
                                 {k: dtype for k in shapes}).source
    assert "race_cp_async_commit();" in src
    assert hashlib.sha256(src.encode()).hexdigest() == F32_F64_SOURCES[
        name + (":" + scalar if scalar else ""), n, dtype]


#: phase 4's half cells: (case, n) -> the next-plane registers of each
#: staged ring, ceil(plane / threads) (256 threads)
HALF_REGISTERS = {("j3d27pt", 512): {"u": 5},
                  ("poisson", 512): {"fp": 4, "u": 5},
                  ("hdifft_gm", 8192): {"S": 5, "T": 5}}


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("name,n", list(HALF_REGISTERS))
def test_half_source_loads_the_next_plane_across_the_step(name, n, dtype):
    """Phase 4's half kernels: at the head of each step, before the first
    aux phase and with no barrier between, every thread issues its
    share of each staged ring's next plane into ``store_t`` registers
    (``race_fetch``, one fixed round after another, the last round's
    threads past the plane left out); after the body it converts them into
    the slot after the lead, ``(r + 1) mod depth``, which no read of the
    step touches; no ``cp.async`` is issued, and the first plane is staged
    before the march as the float32 kernel stages it."""
    case = _phase4_case(name, n)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    shapes = required_shapes(case.program)
    spec = specialize_stencil(res.plan, shapes, {k: dtype for k in shapes})
    f32 = specialize_stencil(res.plan, shapes, {k: "float32" for k in shapes})
    g = spec.tp.geometry
    src = spec.source
    assert "cp_async" not in src and "cp.async" not in src
    head, march = src.split(f"  for (int k = {g.k0}; k < {g.seg}; ++k) {{\n")
    # the first plane: race_stage's converting loads, as float32's
    first = f32.source.split("  race_cp_async_commit();")[0]
    first = first[first.index("  int r"):]
    assert head.endswith(first)
    assert "race_stage(" in first and "race_fetch" not in head
    step = march.split("\n    // body: one output plane")
    loads, rest = step[0], step[1]
    assert loads.startswith("    __syncthreads();\n")
    first_aux = loads.index("    // aux ")
    assert "__syncthreads" not in loads[len("    __syncthreads();"):first_aux]
    staged = {r.name: k for k, r in enumerate(g.rings) if r.operand}
    assert {nm: -(-g.rings[k].plane // g.threads) for nm, k in staged.items()
            } == HALF_REGISTERS[name, n]
    stores = rest[:rest.index("    r0 = r0 + 1")]
    for nm, k in staged.items():
        r, regs = g.rings[k], HALF_REGISTERS[name, n][nm]
        reads = {rd.back for rd in g.reads.values() if rd.ring == k}
        assert max(reads) + 2 == r.depth  # so slot r + 1 is not read
        decl = f"    store_t h{k}[{regs}];"
        assert 0 <= loads.index(decl) < first_aux
        last = r.plane - (regs - 1) * g.threads
        for i in range(regs):
            fetch = loads.index(f"h{k}[{i}] = race_fetch(ok ? src + ")
            assert loads.index(decl) < fetch < first_aux
            # the guards of race_stage's element; the last round's threads
            guard = loads[loads.rindex("{", 0, fetch) - 40:fetch]
            partial = i == regs - 1 and last < g.threads
            assert (f"if (threadIdx.x < {last}) {{" in guard) == partial
            ok = loads[loads.rindex("const bool ok = ", 0, fetch):fetch]
            assert ok.startswith("const bool ok = zok && ")
            assert loads.count(f"a{k}[{i}] = ") == 1
            assert stores.count(f"dst[a{k}[{i}]] = race_acc(h{k}[{i}]);") == 1
        slot = (f"smem + {r.offset} + (r{k} + 1 == {r.depth} ? 0 : r{k} + 1)"
                f" * {r.slot};")
        assert slot in stores and "race_fetch" not in stores
        assert stores.index(slot) < stores.index(f"dst[a{k}[0]]")
        assert stores.count(f"h{k}[") == regs


@pytest.mark.parametrize("dtype", list(HALF))
def test_probe_reckons_four_shared_bytes_per_half_element(dtype,
                                                          monkeypatch):
    seen = []
    real = backend_mod.choose_tile

    def spy(plan, itemsize, *a, **kw):
        seen.append(itemsize)
        return real(plan, itemsize, *a, **kw)

    monkeypatch.setattr(backend_mod, "choose_tile", spy)
    case = get_case("j3d27pt", 10)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    assert probe_hopper(res.plan, [dtype]).eligible
    assert probe_hopper(res.plan, ["float64"]).eligible
    assert seen == [4, 8]


def test_half_source_converts_and_issues_no_two_byte_cp_async():
    """The rendered source instantiates the kernel for ``__half`` computed
    in float and for nothing else, includes the half header (which the
    float32 source does not), converts every operand read and output
    store, stages its first plane through ``race_stage`` and every later
    one through ``race_fetch`` into registers, converted by ``race_acc``
    into shared memory; the headers' only ``cp.async`` sizes are 4 and 8
    bytes, the half overloads of ``race_stage`` are converting loads and
    those of ``race_fetch`` raw loads, zero where the guard fails."""
    case = get_case("j3d27pt", 64)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    shapes = required_shapes(case.program)
    spec = specialize_stencil(res.plan, shapes,
                              {k: "float16" for k in shapes})
    src = spec.source
    assert any(r.operand for r in spec.tp.geometry.rings)
    for code, dt in enumerate(KERNEL_DTYPES):
        kd = KERNEL_DTYPES[dt]
        inst = f"if (dtype == {code}) return launch<{kd.storage}, {kd.acc}>("
        assert (inst in src) == (dt == "float16")
    assert "race_store(out0 + (" in src
    assert "race_stage(" in src and "cp.async" not in src
    assert "= race_fetch(" in src and "] = race_acc(h" in src
    assert "race_cp_async" not in src
    md = get_case("mirror_deriv", 14)  # mirrored: read in place, converted
    res = repro_torch.race(md.program, reassociate=md.reassociate)
    shapes = required_shapes(md.program)
    assert "race_acc(in0[" in specialize_stencil(
        res.plan, shapes, {k: "bfloat16" for k in shapes}).source
    assert "acc_t* const smem" in src and "const store_t* const" in src
    assert included_headers(src) == [CSRC / "race_half.cuh",
                                     CSRC / "race_stencil.cuh"]
    f32 = specialize_stencil(res.plan, shapes, {k: "float32" for k in shapes})
    assert included_headers(f32.source) == [CSRC / "race_stencil.cuh"]
    header = "".join(p.read_text() for p in included_headers(src))
    assert "#include <cuda_fp16.h>" in header
    assert "#include <cuda_bf16.h>" in header
    assert "cuda_fp16" not in (CSRC / "race_stencil.cuh").read_text()
    sizes = re.findall(r"cp\.async\.\w+\.shared\.global \[%0\], \[%1\], "
                       r"(\d+)", header)
    assert sorted(set(sizes)) == ["4", "8"]
    for store_t, conv in (("__half", "__half2float"),
                          ("__nv_bfloat16", "__bfloat162float")):
        body = re.search(r"void race_stage\(float\* dst,\s*const "
                         + store_t + r"\* src,\s*bool ok\) \{(.*?)\}",
                         header, re.S).group(1)
        assert conv in body and "cp_async" not in body
        body = re.search(store_t + r" race_fetch\(const " + store_t
                         + r"\* src,\s*bool ok\) \{(.*?)\}", header,
                         re.S).group(1)
        assert re.fullmatch(r"\s*return ok \? \*src : __ushort_as_\w+\(0\);"
                            r"\s*", body) and "cp_async" not in body
        assert re.search(r"float race_acc\(" + store_t + r" x\) \{\s*return "
                         + conv, header)
    for store_t, conv in (("__half", "__float2half_rn"),
                          ("__nv_bfloat16", "__float2bfloat16_rn")):
        assert re.search(r"void race_store\(" + store_t + r"\* p, float v\) "
                         r"\{\s*\*p = " + conv, header)


def _cos_weights(shape, dtype):
    return np.cos(np.arange(int(np.prod(shape)))).reshape(shape).astype(dtype)


#: j3d27pt and psinv run at n=32: at their sweep size (10) their scalar
#: coefficients' gradients are sums of ~700 float16 terms that cancel to a
#: few hundredths of their size, and the reference's own float16 gradient
#: lies 4.4e-2 (j3d27pt's jc3) from the float64 one, beyond its ``grad``
#: row; at n=32 both packages' float16 sums hold within it.
GRAD_CASES = [("hdifft_gm", 14), ("derivative", 10), ("poisson", 10),
              ("gaussian", 18), ("smooth1d", 24), ("j3d27pt", 32),
              ("psinv", 32)]


@pytest.mark.parametrize("name,n", GRAD_CASES)
def test_float16_gradients_against_reference_jax_grad(name, n):
    """``torch.autograd.grad`` through ``res.run`` on ``"hopper"`` (every
    admitted adjoint spec on the kernel's emulator) against the reference's
    ``jax.grad`` on ``"xla"``, both at float16, the same loss (a cosine
    projection in float16), within the float16 ``grad`` row."""
    rc, pc = ref_case(name, n), get_case(name, n)
    env = build_env(pc, np.float16)
    keys = sorted(env)
    rres = ref_race(rc.program, reassociate=rc.reassociate,
                    rewrite_div=rc.rewrite_div)
    weights = {k: _cos_weights(np.shape(v), np.float16)
               for k, v in rres.run(env, "xla").items()}

    def ref_loss(p):
        out = rres.run({**env, **p}, "xla")
        return sum(jnp.sum(out[k] * w) for k, w in weights.items())

    want = jax.grad(ref_loss)({k: jnp.asarray(env[k]) for k in keys})
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    res = repro_torch.race(pc.program, reassociate=pc.reassociate,
                           rewrite_div=pc.rewrite_div)
    tenv = env_to_torch(env, "cpu")
    p = {k: tenv[k].clone().requires_grad_() for k in keys}
    executor.clear_cache()
    out = res.run({**tenv, **p}, "hopper", device="cpu")
    loss = sum((out[k] * torch.as_tensor(w)).sum()
               for k, w in weights.items())
    grads = torch.autograd.grad(loss, [p[k] for k in keys],
                                allow_unused=True)
    got = {k: torch.zeros_like(p[k]) if g is None else g
           for k, g in zip(keys, grads)}
    assert all(g.dtype == torch.float16 for g in got.values())
    assert rel_err(got, want) <= default_tolerances(np.float16)["grad"]
    # the forward and every adjoint plan ran on the kernel
    backends = {k.backend for k in executor.executor_cache().keys()}
    assert backends == {"hopper"}


def test_tuner_and_serving_reach_the_kernel_at_float16():
    """The tuner enumerates kernel candidates for a float16 signature, and
    ``ServeRuntime`` on ``"auto"`` answers through the kernel, equal to
    ``run``."""
    case = get_case("j3d27pt", 10)
    res = repro_torch.race(case.program, reassociate=case.reassociate)
    env = env_to_torch(build_env(case, np.float16), "cpu")
    sig = executor.env_signature(env)
    configs = candidate_configs({case.reassociate: res.plan}, sig=sig)
    assert "hopper" in {c.backend for c in configs}
    executor.clear_cache()
    want = {k: v.numpy() for k, v in res.run(env, device="cpu").items()}
    with ServeRuntime(device="cpu", backend="auto", max_batch=2,
                      window_us=0, workers=1) as rt:
        got = rt.run(res.plan, build_env(case, np.float16), timeout=120)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    assert {k.backend for k in executor.executor_cache().keys()} == {
        "hopper"}
