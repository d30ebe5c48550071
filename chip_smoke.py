#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: require CUDA; print ``nvidia-smi``'s name and power limit;
  2. build: render the stencil kernel of every plan below and compile them
     all with nvcc at once (one process per source) into build/repro_torch/;
     print the build seconds;
  3. kernel vs plain version: all 19 registry cases x reassociate {0,
     default} x float32/float64 at three times the test sizes — the
     ``"hopper"`` backend against the ``"torch"`` backend on the card within
     the ``plan`` tolerance, both against the float64 baseline program within
     ``baseline``, and the kernel's launch count must rise;
  4. main path at full size: ``race(program).run(env)`` with the default
     ``"auto"`` backend for j3d27pt n=512 f32, poisson n=512 f32, derivative
     n=256 f64 and hdifft_gm 8192x8192 f32.  The selection must be
     ``"hopper"``, the launch count (zeroed just before) must rise, and the
     output must match ``"torch"``; both are timed with CUDA events (median
     of 10 runs after a warm-up) beside the bound of the bytes they must
     move over the card's memory rate, and so is the one PyTorch call that
     computes the same function where there is one (:func:`library_call`).

The last lines are the kernel table as JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Imports no jax and nothing of the JAX
package ``repro``.
"""
from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
#: flop/s per dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
SWEEP_SCALE = 3
REPS = 10


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, torch) -> float:
    """Median over REPS of one call, timed with CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_call(case, env):
    """One PyTorch call that computes the case's outputs from ``env``, as a
    thunk, or None where no single call does.

    j3d27pt is a 3x3x3 cross-correlation of ``u`` with the weights
    ``jc<c> / jnorm`` (``c`` = the number of nonzero offsets of the tap) over
    the same ``[i, k, j]`` interior: one ``F.conv3d``.  It folds ``/ jnorm``
    into the weights and sums in its own order, so it is held to the
    ``baseline`` tolerance.  The other main-path cells have no such call:
    poisson adds a second array (``fp``) to a convolution of ``u``,
    derivative differentiates products of two fields, and hdifft_gm sums
    box filters of two fields (``T`` and ``S``); each needs a second call
    or a stacked copy of its inputs."""
    if case.name != "j3d27pt":
        return None
    import torch
    import torch.nn.functional as F

    u = env["u"]
    w = torch.empty((3, 3, 3), dtype=torch.float64)
    for di, dk, dj in itertools.product((-1, 0, 1), repeat=3):
        c = (di != 0) + (dk != 0) + (dj != 0)
        w[di + 1, dk + 1, dj + 1] = float(env[f"jc{c}"]) / float(env["jnorm"])
    w = w.to(device=u.device, dtype=u.dtype)[None, None]
    x = u[None, None]
    return lambda: {"j27": F.conv3d(x, w)[0, 0]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    # the library yardstick (cuDNN) computes in full float32 and picks its
    # fastest algorithm during the warm-up
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    from repro_torch import compile_plan, race
    from repro_torch.apps import CASES, get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm
    from repro_torch.core.codegen import interior, required_shapes
    from repro_torch.core.ir import count_ops
    from repro_torch.kernels.build import compile_sources
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.lowering.geometry import analyze_plan
    from repro_torch.testing import (SWEEP_SIZES, build_env,
                                     default_tolerances, env_to_torch,
                                     rel_err)

    t_start = time.time()
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- plans of phases 3 and 4 ------------------------------------------
    sweep = []  # (case, level, dtype, RaceResult)
    for name in CASES:
        case = get_case(name, SWEEP_SCALE * SWEEP_SIZES[name])
        for lvl in sorted({0, case.reassociate}):
            res = race(case.program, reassociate=lvl,
                       rewrite_div=case.rewrite_div)
            for dt in (np.float32, np.float64):
                sweep.append((case, lvl, dt, res))
    main_cases = [(get_case("j3d27pt", 512), np.float32),
                  (get_case("poisson", 512), np.float32),
                  (get_case("derivative", 256), np.float64),
                  (pop_hdifft_gm(8192, 8192), np.float32)]
    main_runs = [(case, dt, race(case.program, reassociate=case.reassociate))
                 for case, dt in main_cases]

    # ---- phase 2: build ----------------------------------------------------
    sources = []
    for case, _, dt, res in sweep + [(c, None, d, r) for c, d, r in main_runs]:
        shapes = required_shapes(case.program)
        sources.append(specialize_stencil(
            res.plan, shapes, {k: np.dtype(dt).name for k in shapes}).source)
    t0 = time.time()
    compile_sources(sources)
    print(f"build: {len(set(sources))} kernel sources compiled in "
          f"{time.time() - t0:.1f} s", flush=True)

    # ---- phase 3: kernel vs plain version ----------------------------------
    failures = []
    for case, lvl, dt, res in sweep:
        tol = default_tolerances(dt)
        env = env_to_torch(build_env(case, dt, seed=1), "cuda")
        ex = compile_plan(res.plan, env, "hopper")
        before = ex.kernel_launches
        got = res.run(env, "hopper")
        launched = ex.kernel_launches - before
        plain = res.run(env, "torch")
        env64 = {k: v.double() for k, v in env.items()}
        truth = interior(res.plan, res.baseline_evaluator()(env64))
        torch.cuda.synchronize()
        e_plan = rel_err(got, plain)
        e_base = max(rel_err(got, truth), rel_err(plain, truth))
        ok = (launched == 1 and e_plan <= tol["plan"]
              and e_base <= tol["baseline"])
        line = (f"sweep {case.name} r{lvl} {np.dtype(dt).name}: "
                f"launches {launched} hopper-vs-torch {e_plan:.2e} "
                f"(<= {tol['plan']:.0e}) vs-baseline {e_base:.2e} "
                f"(<= {tol['baseline']:.0e}) {'ok' if ok else 'FAIL'}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    if failures:
        raise SystemExit("phase 3 failed:\n" + "\n".join(failures))

    # ---- phase 4: main path at full size ----------------------------------
    kernels = []
    for case, dt, res in main_runs:
        dname = np.dtype(dt).name
        outs = {st.lhs.name for st in case.program.body}
        env_np = build_env(case, dt, seed=0)
        env = env_to_torch({k: v for k, v in env_np.items()
                            if k not in outs}, "cuda")
        del env_np
        ex = compile_plan(res.plan, env)
        if ex.backend != "hopper":
            raise SystemExit(f"{case.name}: auto selected {ex.backend}: "
                             f"{ex.selection.capability.explain()}")
        ex.spec.launches = 0
        got = res.run(env)
        torch.cuda.synchronize()
        launches = ex.kernel_launches
        if launches < 1:
            raise SystemExit(f"{case.name}: the main path launched no kernel")
        ex_t = compile_plan(res.plan, env, "torch")
        plain = ex_t(env)
        torch.cuda.synchronize()
        e_plan = rel_err(got, plain)
        max_abs = max(float((got[k].double() - plain[k].double()).abs().max())
                      for k in plain)
        tol = default_tolerances(dt)["plan"]
        if e_plan > tol:
            raise SystemExit(f"{case.name}: hopper vs torch {e_plan:.2e} > "
                             f"{tol:.0e}")
        del plain
        lib = library_call(case, env)
        if lib is not None:
            lib_out = lib()
            torch.cuda.synchronize()
            e_lib = rel_err(lib_out, got)
            lib_tol = default_tolerances(dt)["baseline"]
            print(f"library {case.name}: conv3d vs hopper {e_lib:.2e} "
                  f"(<= {lib_tol:.0e})", flush=True)
            if e_lib > lib_tol:
                raise SystemExit(f"{case.name}: library call vs hopper "
                                 f"{e_lib:.2e} > {lib_tol:.0e}")
            del lib_out
        del got
        kernel_ms = _time_ms(lambda: ex(env), torch)
        torch_ms = _time_ms(lambda: ex_t(env), torch)
        library_ms = None if lib is None else _time_ms(lib, torch)
        arrays = analyze_plan(res.plan).arrays
        itemsize = np.dtype(dt).itemsize
        n_in = sum(env[k].numel() for k in arrays) * itemsize
        vol = res.plan.program.volume()
        n_out = vol * len(res.plan.body) * itemsize
        ops = sum(sum(count_ops(st.rhs).values()) for st in res.plan.body) * vol
        for a in res.plan.aux_order:
            rng = res.plan.ranges[a.name]
            avol = 1
            for lo, hi in rng.values():
                avol *= hi - lo + 1
            ops += sum(count_ops(res.plan.aux_exprs[a.name]).values()) * avol
        bytes_ms = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_FLOPS[dname] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        geo = ex.spec.tp.geometry
        print(f"main {case.name} {dname} {tuple(env[next(iter(arrays))].shape)}"
              f": selection hopper, launches {launches}, tile {geo.tile}, "
              f"smem {ex.spec.tp.smem_bytes} B, kernel_ms {kernel_ms:.4f}, "
              f"torch_ms {torch_ms:.4f}, library_ms {library_ms}, "
              f"bytes {n_in + n_out}, bound_ms "
              f"{bound_ms:.4f} ({'bytes' if bytes_ms >= ops_ms else 'ops'}), "
              f"share of bound {bound_ms / kernel_ms:.3f}, max_abs_err "
              f"{max_abs:.3e}, rel_err {e_plan:.2e}", flush=True)
        kernels.append(dict(
            name=f"race_stencil[{case.name}]", route="cuda",
            source="src/repro_torch/lowering/emit.py",
            replaces="src/repro/lowering/emit.py:273",
            launches=launches, max_abs_err=max_abs, ms=kernel_ms,
            plain_ms=torch_ms, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms))
        del env, ex, ex_t, lib
        torch.cuda.empty_cache()

    print(f"total seconds: {time.time() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
