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
     The kernel's schedule is printed: stream level, plane tile, segment
     length, ring depths, shared memory per block and aux evaluations per
     output point (worked out from the tile program, not measured);
  5. gradient sweep: the 19 cases at three times the test sizes, float32,
     ``torch.autograd.grad`` of a cosine-projection loss through
     ``res.run(env)`` against autograd of the float64 baseline program
     within ``grad``; every adjoint spec's backend and probe codes are
     printed, every spec must be on the kernel and launch it once in the
     backward (refused adjoint builds print their code and take autograd);
  6. gradient at full size: the four cells of phase 4, the backward through
     ``res.run`` timed (CUDA events, median of 10 after a warm-up), its
     kernel launches counted (zeroed just before), the gradients held
     against the same adjoint plans on ``"torch"`` within ``plan``, and the
     adjoint kernels timed beside their bound and their ``"torch"`` time;
  7. fused cross-entropy (K4) at the reference's test shapes and at four
     whose T, D and V are no multiple of the tensor-core kernels' tiles (D
     = 37 no multiple of 4), float32 and bfloat16, each with one label out
     of range: the kernel that ``fused_ce.variant`` picks (``"wgmma"``:
     bf16 on the tensor cores, TMA loads; ``"tf32x3"``: float32 on the
     tensor cores after its split pre-pass; ``"ffma"``: bf16 rows TMA
     cannot describe) against its plain version, that variant's launch
     count rising by one (and the pre-pass's by two for ``"tf32x3"``), the
     pre-pass's parts of ``h`` and ``w`` bit for bit against
     ``tf32_split_ref``, and ``fused_ce``'s gradients against autograd of
     the dense loss;
  8. K4 at the LM head of qwen2-7b (T=4096, D=3584, V=152064), bfloat16 on
     the ``"wgmma"`` kernel and float32 on the ``"tf32x3"`` kernel:
     ``fused_ce`` forward and backward once with the launch counts zeroed
     just before (the dtype's variant must launch exactly once, float32's
     pre-pass twice), then the kernel timed beside its plain version, the
     library route (``F.cross_entropy`` of ``torch.matmul``, TF32 off) and
     its bound (float32: three TF32 passes, with the FFMA bound of one f32
     pass beside it), float32's pre-pass timed beside its plain version and
     its bytes bound, then each run back to back for about a second under
     ``torch.profiler`` (device time per kernel, the device's idle share)
     with the host's enqueue time per call and ``nvidia-smi``'s SM clock
     and power sampled meanwhile.  The built library's SASS must hold
     ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in both
     tensor-core kernels, the float32 one in their ``.TF32`` form
     (``cuobjdump`` beside nvcc); their counts and the kernels' registers
     and stack are printed;
  9. ``res.run_batch`` on ``"auto"`` (:func:`batch_cells`: j3d27pt n=256
     f32 B=8, derivative n=128 f64 B=8 with per-example scalars,
     hdifft_gm 2048x2048 f32 B=16, j3d27pt n=64 f32 B=256; the first
     three as many elements as their phase-4 cells, the last half as
     many): the selection must be ``"hopper"``,
     the call must launch K1 exactly once (the batch on ``blockIdx.y``),
     every example must equal ``res.run`` of it on the card bit for bit,
     and the batch the ``"torch"`` batched evaluator within ``plan``; the
     batched kernel, a loop of B ``run`` calls, the ``"torch"`` batched
     evaluator and (j3d27pt) ``F.conv3d`` with N = B are timed (CUDA
     events, median of 10 after a warm-up) beside the bytes bound, and
     each schedule is printed.  Then ``torch.autograd.grad`` through
     ``run_batch`` for j3d27pt_b8: each adjoint spec's kernel launches
     once for the batch, each example's gradient is held against ``run``'s
     within ``grad``, and the batched backward, a loop of B backwards and
     the adjoint kernels are timed;
 10. second order: a Hessian-vector product of ``sum(run(u)**2)`` for
     j3d27pt n=256 f32 on ``"auto"`` against plain autograd of the
     ``"torch"`` evaluator within ``grad``; every executor of the second
     backward must be K1's, and its J^T step (the forward's adjoint) and
     its J v step (the adjoint of that adjoint) must each launch; both
     products are timed.

The last lines are the phase-4 schedules as JSON (``{"schedule": [...]}``),
the kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Imports no jax and nothing of the JAX
package ``repro``.

    python3 chip_smoke.py --tile-sweep

times the stencil kernel instead at forced plane tiles (and, for the 2-D
cell, segment lengths) on the full-size cells of
phase 4, each checked against ``"torch"`` first: the sweep the tile chooser
(``lowering/blocks.py``) is set from.

    python3 chip_smoke.py --tf32-sweep

times K4's 3xTF32 kernel instead at the qwen2-7b head, rebuilt with the
flush periods and ring depths of :data:`TF32_SWEEP` in place of its own,
each with its error against the plain version and the float64 loss: the
sweep ``Tf32x3Op``'s constants (``csrc/fused_ce.cu``) are set from.
"""
from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core
#: flop/s per dtype, and the dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 494.5e12
SWEEP_SCALE = 3
REPS = 10
#: where phases 5-8 put their tensors
DEVICE = "cuda"
#: the LM head of qwen2-7b (src/repro/configs/qwen2_7b.py): one sequence
CE_FULL = dict(T=4096, D=3584, V=152064)
#: the reference's fused-CE test shapes (tests/test_fused_ce.py) plus five
#: whose T, D and V are no multiple of the kernels' tiles (D = 37: rows of
#: no multiple of 16 bytes), and one that fills a tensor-core tile
#: (bfloat16 with V = 100 or D = 37 has rows TMA cannot describe: the FFMA
#: kernel takes it; float32 always takes the 3xTF32 kernel)
CE_SWEEP = [(64, 32, 256, 64), (32, 16, 100, 25), (48, 64, 512, 512),
            (128, 8, 64, 16), (100, 40, 1000, None), (200, 96, 1000, None),
            (300, 136, 4104, None), (128, 64, 4096, 512),
            (72, 37, 515, None)]
#: ``--tile-sweep``: (block_rows, block_cols, block_inner) per cell; 0
#: leaves a level to the chooser.  On the 3-D cells rows and cols set the
#: plane tile (levels 1 and 2), on hdifft_gm rows sets the row tile and
#: inner the segment length.
TILE_SWEEP = {
    "j3d27pt": [(32, 8, 0), (32, 16, 0), (32, 32, 0), (16, 64, 0),
                (64, 16, 0)],
    "poisson": [(32, 8, 0), (32, 16, 0), (32, 32, 0), (64, 16, 0)],
    "derivative": [(32, 4, 0), (32, 8, 0), (16, 8, 0), (16, 16, 0),
                   (16, 4, 0), (8, 16, 0)],
    "hdifft_gm": [(256, 0, 0), (512, 0, 0), (1024, 0, 0), (2048, 0, 0),
                  (1024, 0, 32)],
}
#: ``--tf32-sweep``: (FLUSH, STAGES) of the 3xTF32 kernel; a FLUSH past the
#: 224 slabs of D = 3584 flushes once, at each tile's end
TF32_SWEEP = [(8, 4), (16, 4), (32, 4), (1 << 20, 4), (8, 3), (8, 5)]
#: the constants of ``Tf32x3Op`` that ``--tf32-sweep`` replaces
TF32_CONSTANTS = ("  static constexpr int STAGES = {stages};\n"
                  "  static constexpr int FLUSH = {flush};")


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
    or a stacked copy of its inputs.  With a leading batch axis (phase 9)
    the call is ``F.conv3d`` with N = B, where every example has the same
    scalars (else None)."""
    if case.name != "j3d27pt":
        return None
    import torch
    import torch.nn.functional as F

    u = env["u"]
    scal = {k: env[k].reshape(-1) for k in ("jc0", "jc1", "jc2", "jc3",
                                             "jnorm")}
    if u.dim() == 4:  # a batch: one conv3d with N = B needs one weight set
        if not all(bool((v == v[0]).all()) for v in scal.values()):
            return None
    w = torch.empty((3, 3, 3), dtype=torch.float64)
    for di, dk, dj in itertools.product((-1, 0, 1), repeat=3):
        c = (di != 0) + (dk != 0) + (dj != 0)
        w[di + 1, dk + 1, dj + 1] = (float(scal[f"jc{c}"][0])
                                     / float(scal["jnorm"][0]))
    w = w.to(device=u.device, dtype=u.dtype)[None, None]
    if u.dim() == 4:
        x = u[:, None]
        return lambda: {"j27": F.conv3d(x, w)[:, 0]}
    x = u[None, None]
    return lambda: {"j27": F.conv3d(x, w)[0, 0]}


def plan_work(plan, env, itemsize: int) -> tuple:
    """``(bytes, operations)`` one run of ``plan`` must do: every kernel
    operand read once, every output written once; every body and aux
    operation once per point of its box."""
    from repro_torch.core.ir import count_ops
    from repro_torch.lowering.geometry import kernel_analysis

    arrays = kernel_analysis(plan).arrays
    n_in = sum(env[k].numel() for k in arrays) * itemsize
    vol = plan.program.volume()
    n_out = vol * len(plan.body) * itemsize
    ops = sum(sum(count_ops(st.rhs).values()) for st in plan.body) * vol
    for a in plan.aux_order:
        avol = 1
        for lo, hi in plan.ranges[a.name].values():
            avol *= hi - lo + 1
        ops += sum(count_ops(plan.aux_exprs[a.name]).values()) * avol
    return n_in + n_out, ops


def bound_of(nbytes: float, ops: float, peak_flops: float) -> tuple:
    """``(bound ms, "bytes" or "operations")``: the larger of the two."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak_flops * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def cos_weights(outs: dict, torch) -> dict:
    """The fixed projection of the gradient checks: output element ``i``
    weighs ``cos(i)``, in the output's dtype."""
    return {k: torch.cos(torch.arange(v.numel(), device=v.device,
                                      dtype=torch.float64)).to(v.dtype)
            .reshape(v.shape) for k, v in outs.items()}


def adjoint_sources(case, res, dt) -> list:
    """Kernel sources of the case's adjoint plans that ``"auto"`` sends to
    the kernel at the case's full shapes, built ahead of the backward."""
    import numpy as np

    from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
    from repro_torch.core.backend import select_backend
    from repro_torch.core.codegen import required_shapes
    from repro_torch.lowering.emit import specialize_stencil

    shapes = required_shapes(case.program)
    dname = np.dtype(dt).name
    out = []
    for spec in adjoint_build(case.program).specs:
        plan = spec.result().plan
        adj = adjoint_env_shapes(spec, case.program, shapes)
        if select_backend(plan, "auto", [dname]).backend == "hopper":
            out.append(specialize_stencil(
                plan, adj, {k: dname for k in adj}).source)
    return out


def adjoint_executors(program, env, g) -> list:
    """``(spec, adjoint env, executor)`` for each adjoint plan, as the
    backward fetches them from the executor cache (default backend)."""
    from repro_torch import compile_plan
    from repro_torch.core.adjoint import adjoint_build, assemble_adjoint_env

    out = []
    for spec in adjoint_build(program).specs:
        adj_env = assemble_adjoint_env(spec, env, g)
        out.append((spec, adj_env,
                    compile_plan(spec.result().plan, adj_env)))
    return out


def grad_sweep(sweep_cases, torch) -> list:
    """Phase 5; returns the failures."""
    import numpy as np

    from repro_torch.core.adjoint import adjoint_build
    from repro_torch.core.codegen import interior
    from repro_torch.testing import (build_env, default_tolerances,
                                     env_to_torch, rel_err)

    failures = []
    on_kernel = 0
    for case, res in sweep_cases:
        tol = default_tolerances(np.float32)["grad"]
        env = env_to_torch(build_env(case, np.float32, seed=1), DEVICE)
        keys = sorted(k for k, v in env.items() if v.is_floating_point())
        p = {k: env[k].clone().requires_grad_() for k in keys}
        out = res.run({**env, **p}, device=DEVICE)
        g = cos_weights(out, torch)
        build = adjoint_build(case.program)
        adj = adjoint_executors(case.program, env, g)
        before = [ex.kernel_launches for _, _, ex in adj]
        grads = torch.autograd.grad([out[k] for k in g],
                                    [p[k] for k in keys],
                                    [g[k] for k in g], allow_unused=True)
        torch.cuda.synchronize()
        env64 = {k: v.double().requires_grad_() if k in keys else v
                 for k, v in env.items()}
        base = interior(res.plan, res.baseline_evaluator()(env64))
        want = torch.autograd.grad([base[k] for k in g],
                                   [env64[k] for k in keys],
                                   [g[k].double() for k in g],
                                   allow_unused=True)
        zero = torch.zeros((), device=DEVICE)
        err = rel_err({k: zero if v is None else v
                       for k, v in zip(keys, grads)},
                      {k: zero if v is None else v
                       for k, v in zip(keys, want)})
        specs = []
        ok = err <= tol
        for (spec, _, ex), b in zip(adj, before):
            launched = ex.kernel_launches - b
            codes = ",".join(r.code for r in ex.selection.capability.reasons)
            specs.append(f"{spec.input}:{ex.backend}"
                         f"[{codes or 'eligible'}] launches {launched}")
            ok &= ex.backend == "hopper" and launched == 1
            on_kernel += ex.backend == "hopper"
        adjoint = ("adjoint " + "; ".join(specs) if build.ok
                   else f"autodiff fallback: {build.reason}")
        line = (f"grad {case.name} r{case.reassociate} float32: grads vs "
                f"float64 baseline {err:.2e} (<= {tol:.0e}); {adjoint} "
                f"{'ok' if ok else 'FAIL'}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    print(f"grad sweep: {on_kernel} adjoint specs on the kernel", flush=True)
    return failures


def grad_full_size(case, dt, res, torch) -> dict:
    """Phase 6 for one cell; returns its kernel line (the adjoint plans'
    kernels) and prints the backward's time and launches."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.adjoint import backward
    from repro_torch.testing import build_env, default_tolerances, rel_err

    dname = np.dtype(dt).name
    outs = {st.lhs.name for st in case.program.body}
    env = {k: torch.as_tensor(v, device=DEVICE)
           for k, v in build_env(case, dt, seed=0).items() if k not in outs}
    keys = sorted(k for k, v in env.items() if v.is_floating_point())
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p}, device=DEVICE)
    g = cos_weights(out, torch)
    adj = adjoint_executors(case.program, env, g)
    kern = [(spec, a, ex) for spec, a, ex in adj if ex.backend == "hopper"]
    for _, _, ex in kern:
        ex.spec.launches = 0

    def bwd():
        return torch.autograd.grad([out[k] for k in g],
                                   [p[k] for k in keys],
                                   [g[k] for k in g], retain_graph=True,
                                   allow_unused=True)

    grads = bwd()
    torch.cuda.synchronize()
    launches = sum(ex.kernel_launches for _, _, ex in kern)
    if not kern or launches != len(kern):
        raise SystemExit(f"{case.name}: the backward launched {launches} "
                         f"kernels for {len(kern)} admitted adjoint plans")
    plain = backward(case.program, env, g, backend="torch")
    e_plan = rel_err({k: v for k, v in zip(keys, grads) if v is not None},
                     {k: plain[k] for k, v in zip(keys, grads)
                      if v is not None})
    max_abs = max(float((v.double() - plain[k].double()).abs().max())
                  for k, v in zip(keys, grads) if v is not None)
    tol = default_tolerances(dt)["plan"]
    if e_plan > tol:
        raise SystemExit(f"{case.name}: backward vs torch adjoint plans "
                         f"{e_plan:.2e} > {tol:.0e}")
    del grads, plain
    backward_ms = _time_ms(bwd, torch)
    plain_backward_ms = _time_ms(
        lambda: backward(case.program, env, g, backend="torch"), torch)
    kernel_ms = torch_ms = 0.0
    nbytes = ops = 0
    itemsize = np.dtype(dt).itemsize
    per_spec = []
    for spec, a, ex in kern:
        ms = _time_ms(lambda: ex(a), torch)
        kernel_ms += ms
        per_spec.append(f"{spec.input} {ms:.4f}")
        ex_t = compile_plan(spec.result().plan, a, "torch")
        torch_ms += _time_ms(lambda: ex_t(a), torch)
        b, o = plan_work(spec.result().plan, a, itemsize)
        nbytes, ops = nbytes + b, ops + o
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    on_torch = [f"{spec.input}[{','.join(r.code for r in ex.selection.capability.reasons)}]"
                for spec, _, ex in adj if ex.backend != "hopper"]
    print(f"grad-main {case.name} {dname}: adjoint specs {len(adj)}, on the "
          f"kernel {len(kern)}, on torch {on_torch or 'none'}; backward "
          f"launches {launches}, backward_ms {backward_ms:.4f} (torch "
          f"adjoint plans {plain_backward_ms:.4f}); adjoint kernels "
          f"kernel_ms {kernel_ms:.4f}, torch_ms {torch_ms:.4f}, bytes "
          f"{nbytes}, bound_ms {bound_ms:.4f} ({by}), share of bound "
          f"{bound_ms / kernel_ms:.3f}; grads vs torch {e_plan:.2e} (<= "
          f"{tol:.0e}), max_abs_err {max_abs:.3e}; per spec ms: "
          f"{', '.join(per_spec)}", flush=True)
    return dict(name=f"race_stencil[{case.name} adjoint]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273", launches=launches,
                max_abs_err=max_abs, ms=kernel_ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def ce_sweep(torch) -> list:
    """Phase 7; returns the failures."""
    from repro_torch.kernels import fused_ce as fc

    failures = []
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for T, D, V, v_blk in CE_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            h = torch.randn(T, D, generator=gen, device=DEVICE).to(dt)
            w = (torch.randn(D, V, generator=gen, device=DEVICE)
                 * 0.05).to(dt)
            labels = torch.randint(0, V, (T,), generator=gen, device=DEVICE,
                                   dtype=torch.int32)
            # one label past V: its gold logit is 0 (the dense loss and the
            # backward gather, so they take the labels in range)
            oor = labels.clone()
            oor[0] = V
            kind = fc.variant(h, w)
            before = dict(fc.KERNEL.launches_by_variant)
            total, splits = fc.KERNEL.launches, fc.KERNEL.split_launches
            got = fc.fused_ce_forward(h, w, oor, v_blk=v_blk)
            launched = fc.KERNEL.launches_by_variant[kind] - before[kind]
            launched_all = fc.KERNEL.launches - total
            split_launched = fc.KERNEL.split_launches - splits
            want = fc.fused_ce_forward_ref(h, w, oor, v_blk=v_blk)
            # the pre-pass's parts against its plain version, bit for bit
            split_ok = dt != torch.float32 or all(
                torch.equal(fc.tf32_split(x, tr).view(torch.int32),
                            fc.tf32_split_ref(x, tr).view(torch.int32))
                for x, tr in ((h, False), (w, True)))
            hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
            loss = fc.fused_ce(hg, wg, labels, v_blk=v_blk)
            dh, dw = torch.autograd.grad(loss, (hg, wg))
            hd, wd = h.clone().requires_grad_(), w.clone().requires_grad_()
            dense = fc._ce_ref(hd, wd, labels)
            rh, rw = torch.autograd.grad(dense, (hd, wd))
            torch.cuda.synchronize()
            e_fwd = float((got - want).abs().max() / want.abs().max())
            e_loss = abs(float(loss.detach()) - float(dense.detach())) / abs(
                float(dense.detach()))
            e_grad = max(float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
                         for a, b in ((dh, rh), (dw, rw)))
            # products of bf16 or f32 inputs, summed in f32 over D in
            # another order: 1e-5; the mean against the dense loss
            # likewise; gradients are the same recompute
            want_split = 2 if kind == "tf32x3" else 0
            ok = (launched == 1 and launched_all == 1 and e_fwd <= 1e-5
                  and e_loss <= 1e-5 and e_grad <= 1e-5
                  and split_launched == want_split and split_ok)
            line = (f"ce {T}x{D}x{V} v_blk={v_blk} {str(dt)[6:]}: variant "
                    f"{kind}, launches {launched} (pre-pass "
                    f"{split_launched}) kernel-vs-plain {e_fwd:.2e} (<= "
                    f"1e-05) pre-pass-vs-plain "
                    f"{'none' if dt != torch.float32 else 'bit-equal' if split_ok else 'DIFFERS'} "
                    f"loss-vs-dense "
                    f"{e_loss:.2e} grads-vs-dense {e_grad:.2e} "
                    f"{'ok' if ok else 'FAIL'}")
            print(line, flush=True)
            if not ok:
                failures.append(line)
    return failures


#: the tensor-core kernels of ``fused_ce.cu`` whose SASS phase 8 checks
TC_KERNELS = ("fused_ce_wgmma_kernel", "fused_ce_tf32x3_kernel")


def sass_counts() -> dict:
    """Per tensor-core kernel of the built ``fused_ce.cu`` library: its
    ``HGMMA`` and ``UTMALDG`` instructions, the ``HGMMA`` of ``.TF32`` form,
    in the SASS (``cuobjdump --dump-sass``), and its resource line
    (``--dump-resource-usage``)."""
    from repro_torch.kernels import build

    so = build.library_path(build.csrc_source("fused_ce.cu"))
    tool = str(Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    usage = subprocess.run([tool, "--dump-resource-usage", str(so)],
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.splitlines()
    out = {k: dict(HGMMA=0, UTMALDG=0, TF32=0, resources="not found")
           for k in TC_KERNELS}
    fn = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((k for k in TC_KERNELS if k in ln), None)
        elif fn and "/*" in ln:
            for op in ("HGMMA", "UTMALDG"):
                out[fn][op] += f" {op}" in ln
            out[fn]["TF32"] += " HGMMA" in ln and ".TF32" in ln
    for i, ln in enumerate(usage[1:], 1):
        for k in TC_KERNELS:
            if k in usage[i - 1]:
                out[k]["resources"] = ln.strip()
    return out


def sustained(fn, torch, ms_each: float) -> dict:
    """About a second of back-to-back calls of ``fn`` under
    ``torch.profiler``, with ``nvidia-smi`` sampling the SM clock (MHz) and
    board power (W) every 50 ms (its process is stopped before returning;
    only samples stamped inside the calls count): event ms per call, host
    ms per call (the time to enqueue one while the device is busy), device
    ms per call of each kernel, and the device's idle share of the window
    (1 - the kernels' device time over the window's wall time, the final
    synchronize included)."""
    from torch.profiler import ProfilerActivity, profile

    n = max(3, round(1000 / ms_each))
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0, wall0 = time.perf_counter(), time.time()
            for _ in range(n):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / n
            end.record()
            end.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            wall1 = time.time()
    finally:
        smi.terminate()
        samples, _ = smi.communicate(timeout=30)
    kernels = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split()[-1]  # drop "void"
            kernels[name] = e.self_device_time_total / n / 1e3
    rows = []
    for ln in samples.splitlines():
        stamp, mhz, watts = ln.split(",")
        at = datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f")
        if wall0 <= at.timestamp() <= wall1:
            rows.append((float(mhz), float(watts)))
    clocks = [c for c, _ in rows]
    power = [w for _, w in rows]
    return dict(calls=n, ms=start.elapsed_time(end) / n, host_ms=host_ms,
                samples=len(rows),
                kernels=kernels,
                idle=1 - sum(kernels.values()) * n / wall_ms,
                sm_mhz=(min(clocks), statistics.median(clocks), max(clocks))
                if clocks else None,
                power_w=(statistics.median(power), max(power))
                if power else None)


def ce_split_full_width(h, w, launches: int, torch) -> dict:
    """Phase 8, float32: the 3xTF32 pre-pass on ``h`` and ``w`` at full
    width, bit for bit against its plain version, timed beside it and its
    bound (each input byte read once, each part written once); returns its
    kernel line, ``launches`` being the main path's."""
    from repro_torch.kernels import fused_ce as fc

    def kernel():
        return fc.tf32_split(h), fc.tf32_split(w, transpose=True)

    def plain():
        return fc.tf32_split_ref(h), fc.tf32_split_ref(w, transpose=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    out_elems = sum(a.numel() for a in got)
    del got, want
    if not same:
        raise SystemExit(f"tf32 split full width: parts differ from the "
                         f"plain version (max abs {max_abs:.3e})")
    ms = _time_ms(kernel, torch)
    plain_ms = _time_ms(plain, torch)
    nbytes = (h.numel() + w.numel() + out_elems) * 4
    bound_ms, by = bound_of(nbytes, 0, PEAK_FLOPS["float32"])
    print(f"ce-split T={h.shape[0]} D={h.shape[1]} V={w.shape[1]}: hi and "
          f"lo of h as (T, Dp), of w as (V, Dp), launches {launches}, "
          f"bit-equal to plain, split_ms "
          f"{ms:.4f}, plain_ms {plain_ms:.4f}, bytes {nbytes}, bound_ms "
          f"{bound_ms:.4f} ({by}), share of bound {bound_ms / ms:.4f}",
          flush=True)
    return dict(name="fused_ce_split", route="cuda",
                source="src/repro_torch/csrc/fused_ce.cu",
                replaces="src/repro/kernels/fused_ce.py:75",
                launches=launches, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def ce_full_width(torch) -> list:
    """Phase 8; returns K4's kernel lines: bfloat16 (``"wgmma"``), float32
    (``"tf32x3"``) and float32's split pre-pass."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_ce as fc

    counts = sass_counts()
    for k, c in counts.items():
        print(f"ce-sass {k}: HGMMA {c['HGMMA']} (of .TF32 form "
              f"{c['TF32']}), UTMALDG {c['UTMALDG']}; {c['resources']}",
              flush=True)
    if (any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values())
            or counts["fused_ce_tf32x3_kernel"]["TF32"] == 0):
        raise SystemExit("fused_ce: a tensor-core kernel has no HGMMA or "
                         "UTMALDG in the SASS, or the tf32x3 kernel no "
                         "HGMMA of .TF32 form")
    T, D, V = CE_FULL["T"], CE_FULL["D"], CE_FULL["V"]
    lines = []
    # float32 does three TF32 passes (hi*lo, lo*hi, hi*hi) on the tensor
    # cores, and goes through its split pre-pass (two launches)
    for dt, want_kind, peak, passes, splits in (
            (torch.bfloat16, "wgmma", PEAK_BF16_TC_FLOPS, 1, 0),
            (torch.float32, "tf32x3", PEAK_TF32_TC_FLOPS, 3, 2)):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        h = torch.randn(T, D, generator=gen, device=DEVICE).to(dt)
        w = (torch.randn(D, V, generator=gen, device=DEVICE) * 0.05).to(dt)
        labels = torch.randint(0, V, (T,), generator=gen, device=DEVICE,
                               dtype=torch.int32)
        kind = fc.variant(h, w)
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        fc.KERNEL.zero_counts()
        loss = fc.fused_ce(hg, wg, labels)
        dh, dw = torch.autograd.grad(loss, (hg, wg))
        torch.cuda.synchronize()
        launches = fc.KERNEL.launches_by_variant[want_kind]
        split_launches = fc.KERNEL.split_launches
        if (kind != want_kind or launches != 1 or fc.KERNEL.launches != 1
                or split_launches != splits):
            raise SystemExit(f"fused_ce {dt}: variant {kind}, launches "
                             f"{fc.KERNEL.launches_by_variant}, pre-pass "
                             f"{split_launches}; want one {want_kind} launch "
                             f"and {splits} of the pre-pass")
        if not (torch.isfinite(loss) and bool(torch.isfinite(dh).all())
                and bool(torch.isfinite(dw).all())):
            raise SystemExit(f"fused_ce {dt}: non-finite loss or gradients")
        del hg, wg, dh, dw
        got = fc.fused_ce_forward(h, w, labels)
        want = fc.fused_ce_forward_ref(h, w, labels, t_blk=T)
        lib = F.cross_entropy(torch.matmul(h, w).float(), labels.long(),
                              reduction="none")
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        e_plain = max_abs / float(want.abs().max())
        e_lib = float((lib - got).abs().max() / got.abs().max())
        del want, lib
        # plain: the same split and f32 products (float32: within 2**-22 of
        # them, the tensor cores' sum flushed to round-to-nearest), summed
        # in another order: 1e-5; library: bf16 logits from a bf16 GEMM,
        # the reference's bf16 tolerance 2e-2 (f32 logits in f32: well
        # inside it)
        if e_plain > 1e-5 or e_lib > 2e-2:
            raise SystemExit(f"fused_ce full width {dt}: kernel vs plain "
                             f"{e_plain:.2e} (<= 1e-05), library vs kernel "
                             f"{e_lib:.2e} (<= 2e-02)")
        if splits:
            lines.append(ce_split_full_width(h, w, split_launches, torch))
        call = lambda: fc.fused_ce_forward(h, w, labels)
        kernel_ms = _time_ms(call, torch)
        plain_ms = _time_ms(lambda: fc.fused_ce_forward_ref(h, w, labels,
                                                            t_blk=T), torch)
        library_ms = _time_ms(lambda: F.cross_entropy(
            torch.matmul(h, w).float(), labels.long(), reduction="none"),
            torch)
        hot = sustained(call, torch, kernel_ms)
        nbytes = (h.numel() + w.numel()) * h.element_size() + T * 4 + T * 4
        bound_ms, by = bound_of(nbytes, passes * 2 * T * D * V, peak)
        ffma = ""
        if dt == torch.float32:
            ffma_ms, _ = bound_of(nbytes, 2 * T * D * V, PEAK_FLOPS["float32"])
            ffma = (f" (one f32 pass on the CUDA cores: {ffma_ms:.4f}, "
                    f"share {ffma_ms / kernel_ms:.4f})")
        width = fc.split_width(T, V, variant=kind)
        print(f"ce-main T={T} D={D} V={V} {str(dt)[6:]}: variant {kind}, "
              f"split width {width} ({-(-V // width)} splits), launches "
              f"{launches} (pre-pass {split_launches}), kernel_ms "
              f"{kernel_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
              f"{library_ms:.4f}, bytes {nbytes}, bound_ms {bound_ms:.4f} "
              f"({by}, {passes} tensor-core pass{'es' * (passes > 1)}), "
              f"share of bound {bound_ms / kernel_ms:.4f}{ffma}, "
              f"kernel-vs-plain {e_plain:.2e}, library-vs-kernel "
              f"{e_lib:.2e}, max_abs_err {max_abs:.3e}", flush=True)
        print(f"ce-sustained {str(dt)[6:]}: {hot['calls']} calls back to "
              f"back under torch.profiler, {hot['ms']:.4f} ms each (events), "
              f"host {hot['host_ms']:.4f} ms each to enqueue; device ms per "
              f"call: " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in hot["kernels"].items())
              + f"; device idle share {hot['idle']:.4f}; SM clock MHz "
              f"min/median/max {hot['sm_mhz']}, power W median/max "
              f"{hot['power_w']} ({hot['samples']} nvidia-smi samples "
              f"inside the calls)", flush=True)
        name = "fused_ce" if dt == torch.bfloat16 else "fused_ce[float32]"
        lines.append(dict(name=name, route="cuda", variant=kind,
                          source="src/repro_torch/csrc/fused_ce.cu",
                          replaces="src/repro/kernels/fused_ce.py:75",
                          launches=launches, max_abs_err=max_abs,
                          ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=by, library_ms=library_ms))
        del h, w, labels, got, loss
        torch.cuda.empty_cache()
    return lines


def batch_cells():
    """The cells of phase 9: (label, case, dtype, B), each with as many
    elements as its phase-4 cell (so the same bytes bound)."""
    import numpy as np

    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm

    return [("j3d27pt_b8", get_case("j3d27pt", 256), np.float32, 8),
            ("derivative_b8", get_case("derivative", 128), np.float64, 8),
            ("hdifft_gm_b16", pop_hdifft_gm(2048, 2048), np.float32, 16),
            ("j3d27pt_b256", get_case("j3d27pt", 64), np.float32, 256)]


def batch_envs(case, dt, B: int) -> list:
    """``B`` numpy envs of the case, outputs left out: arrays from seeds
    0..B-1; j3d27pt's scalars from seed 0 in every example (so that one
    ``F.conv3d`` with N = B computes the batch), other cases' per example."""
    from repro_torch.testing import build_env

    outs = {st.lhs.name for st in case.program.body}
    envs = [{k: v for k, v in build_env(case, dt, seed=b).items()
             if k not in outs} for b in range(B)]
    if case.name == "j3d27pt":
        for e in envs[1:]:
            e.update({k: envs[0][k] for k in case.scalars})
    return envs


def batch_main(label, case, dt, B, res, torch) -> dict:
    """Phase 9 for one cell: ``res.run_batch`` on ``"auto"``; returns its
    kernel line."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.executor import stack_envs, stacked_signature
    from repro_torch.testing import default_tolerances, rel_err

    dname = np.dtype(dt).name
    stacked = stack_envs(batch_envs(case, dt, B), DEVICE)
    sig = stacked_signature(stacked)
    ex = compile_plan(res.plan, sig, device=DEVICE)
    if ex.backend != "hopper":
        raise SystemExit(f"{label}: auto selected {ex.backend}: "
                         f"{ex.selection.capability.explain()}")
    ex.spec.launches = 0
    got = res.run_batch(stacked, device=DEVICE)
    torch.cuda.synchronize()
    launches = ex.kernel_launches
    if launches != 1:
        raise SystemExit(f"{label}: run_batch launched {launches} kernels, "
                         f"want 1")
    examples = [{k: v[b] for k, v in stacked.items()} for b in range(B)]
    for b, env in enumerate(examples):
        per = res.run(env, device=DEVICE)
        if not all(torch.equal(got[k][b], per[k]) for k in per):
            raise SystemExit(f"{label}: example {b} of run_batch differs "
                             f"from run")
    del per
    ex_t = compile_plan(res.plan, sig, "torch", device=DEVICE)
    plain = ex_t.run_batch(stacked)
    torch.cuda.synchronize()
    e_plan = rel_err(got, plain)
    max_abs = max(float((got[k].double() - plain[k].double()).abs().max())
                  for k in plain)
    tol = default_tolerances(dt)["plan"]
    if e_plan > tol:
        raise SystemExit(f"{label}: run_batch vs torch batched {e_plan:.2e} "
                         f"> {tol:.0e}")
    del plain
    lib = library_call(case, stacked)
    if lib is not None:
        e_lib = rel_err(lib(), got)
        torch.cuda.synchronize()
        lib_tol = default_tolerances(dt)["baseline"]
        print(f"library {label}: conv3d N={B} vs hopper {e_lib:.2e} (<= "
              f"{lib_tol:.0e})", flush=True)
        if e_lib > lib_tol:
            raise SystemExit(f"{label}: library call vs hopper {e_lib:.2e} "
                             f"> {lib_tol:.0e}")
    del got
    kernel_ms = _time_ms(lambda: ex.run_batch(stacked), torch)
    loop_ms = _time_ms(lambda: [ex(env) for env in examples], torch)
    torch_ms = _time_ms(lambda: ex_t.run_batch(stacked), torch)
    library_ms = None if lib is None else _time_ms(lib, torch)
    nbytes, ops = plan_work(res.plan, examples[0], np.dtype(dt).itemsize)
    bound_ms, by = bound_of(nbytes * B, ops * B, PEAK_FLOPS[dname])
    tp = ex.spec.tp
    geo = tp.geometry
    print(f"batch-schedule {label}: stream level {geo.s_level}, plane tile "
          f"{tuple(geo.tile[l - 1] for l in geo.order)} (levels "
          f"{geo.order}), segment {geo.seg}, warm-up {-geo.k0}, blocks per "
          f"example {geo.n_tiles}, ring depths "
          f"{ {r.name: r.depth for r in geo.rings} }, smem {tp.smem_bytes} "
          f"B, aux_evals_per_point {tp.aux_evals_per_point:.3f}", flush=True)
    print(f"batch {label} {dname} B={B} "
          f"{tuple(stacked[tp.operands[0].name].shape)}: "
          f"selection hopper, launches {launches} (grid y = B), bit-equal "
          f"to run per example; kernel_ms {kernel_ms:.4f}, loop of {B} runs "
          f"ms {loop_ms:.4f}, torch batched ms {torch_ms:.4f}, library_ms "
          f"{library_ms}, bytes {nbytes * B}, bound_ms {bound_ms:.4f} ({by}),"
          f" share of bound {bound_ms / kernel_ms:.3f}, vs torch "
          f"{e_plan:.2e}, max_abs_err {max_abs:.3e}", flush=True)
    return dict(name=f"race_stencil[{label}]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273", launches=launches,
                max_abs_err=max_abs, ms=kernel_ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
                run_loop_ms=loop_ms, batch=B)


def batch_grad(label, case, dt, B, res, torch) -> dict:
    """Phase 9's gradient: ``torch.autograd.grad`` through ``run_batch``;
    the adjoint kernels launch once per spec, each example's gradient is
    held against ``run``'s; returns the adjoint kernels' line."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.adjoint import adjoint_build, assemble_adjoint_env
    from repro_torch.core.executor import stack_envs, stacked_signature
    from repro_torch.testing import default_tolerances, rel_err

    dname = np.dtype(dt).name
    stacked = stack_envs(batch_envs(case, dt, B), DEVICE)
    keys = sorted(k for k, v in stacked.items() if v.is_floating_point())
    p = {k: stacked[k].clone().requires_grad_() for k in keys}
    out = res.run_batch({**stacked, **p}, device=DEVICE)
    g = cos_weights(out, torch)
    adj = []
    for spec in adjoint_build(case.program).specs:
        a = assemble_adjoint_env(spec, stacked, g)
        adj.append((spec, a, compile_plan(spec.result().plan,
                                          stacked_signature(a),
                                          device=DEVICE)))
    if not all(ex.backend == "hopper" for _, _, ex in adj):
        raise SystemExit(f"{label}: an adjoint spec is not on the kernel")
    for _, _, ex in adj:
        ex.spec.launches = 0

    def bwd():
        return torch.autograd.grad([out[k] for k in g], [p[k] for k in keys],
                                   [g[k] for k in g], retain_graph=True)

    grads = dict(zip(keys, bwd()))
    torch.cuda.synchronize()
    launched = [ex.kernel_launches for _, _, ex in adj]
    if launched != [1] * len(adj):
        raise SystemExit(f"{label}: batched backward launches per spec "
                         f"{launched}, want 1 each")
    tol = default_tolerances(dt)["grad"]
    per_bwd, err = [], 0.0
    for b in range(B):
        q = {k: stacked[k][b].clone().requires_grad_() for k in keys}
        o = res.run({**{k: v[b] for k, v in stacked.items()}, **q},
                    device=DEVICE)
        gb = {k: v[b] for k, v in g.items()}
        per_bwd.append((o, q, gb))
        want = torch.autograd.grad([o[k] for k in gb], [q[k] for k in keys],
                                   [gb[k] for k in gb], retain_graph=True)
        err = max(err, rel_err({k: grads[k][b] for k in keys},
                               dict(zip(keys, want))))
    if err > tol:
        raise SystemExit(f"{label}: batched gradients vs run's {err:.2e} > "
                         f"{tol:.0e}")
    del grads
    backward_ms = _time_ms(bwd, torch)
    loop_ms = _time_ms(lambda: [torch.autograd.grad(
        [o[k] for k in gb], [q[k] for k in keys], [gb[k] for k in gb],
        retain_graph=True) for o, q, gb in per_bwd], torch)
    kernel_ms = torch_ms = 0.0
    nbytes = ops = 0
    max_abs = 0.0
    itemsize = np.dtype(dt).itemsize
    for spec, a, ex in adj:
        kernel_ms += _time_ms(lambda: ex.run_batch(a), torch)
        ex_t = compile_plan(spec.result().plan, stacked_signature(a),
                            "torch", device=DEVICE)
        torch_ms += _time_ms(lambda: ex_t.run_batch(a), torch)
        k_out, t_out = ex.run_batch(a), ex_t.run_batch(a)
        max_abs = max(max_abs, max(float((k_out[k].double()
                                          - t_out[k].double()).abs().max())
                                   for k in t_out))
        b_, o_ = plan_work(spec.result().plan,
                           {k: v[0] for k, v in a.items()}, itemsize)
        nbytes, ops = nbytes + b_ * B, ops + o_ * B
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    print(f"batch-grad {label} {dname} B={B}: adjoint specs {len(adj)}, all "
          f"on the kernel, launches per spec {launched}; backward_ms "
          f"{backward_ms:.4f}, loop of {B} backwards ms {loop_ms:.4f}; "
          f"adjoint kernels kernel_ms {kernel_ms:.4f}, torch batched ms "
          f"{torch_ms:.4f}, bytes {nbytes}, bound_ms {bound_ms:.4f} ({by}), "
          f"share of bound {bound_ms / kernel_ms:.3f}; grads vs run's "
          f"{err:.2e} (<= {tol:.0e}), adjoint max_abs_err {max_abs:.3e}",
          flush=True)
    return dict(name=f"race_stencil[{label} adjoint]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273",
                launches=sum(launched), max_abs_err=max_abs, ms=kernel_ms,
                plain_ms=torch_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None, batch=B)


def hvp_check(case, dt, res, torch) -> None:
    """Phase 10: a Hessian-vector product of ``sum(run(u)**2)`` through
    ``res.run`` on ``"auto"`` against the same product by plain autograd of
    the ``"torch"`` evaluator, within ``grad``.  Every executor of the
    second backward must be K1's, and both of its steps must launch: the
    J^T step (the forward's adjoint) and the J v step (the adjoint of that
    adjoint)."""
    import numpy as np

    from repro_torch import compile_plan, executor_cache, plan_hash
    from repro_torch.core.adjoint import COTANGENT_PREFIX, adjoint_build
    from repro_torch.core.codegen import build_plan_evaluator, interior
    from repro_torch.testing import default_tolerances, rel_err

    env = {k: torch.as_tensor(v, device=DEVICE)
           for k, v in batch_envs(case, dt, 1)[0].items()}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    v = torch.randn(env["u"].shape, generator=gen, device=DEVICE,
                    dtype=env["u"].dtype)
    plan_run = build_plan_evaluator(res.plan)
    fwd = compile_plan(res.plan, env)
    if fwd.backend != "hopper":
        raise SystemExit(f"hvp: auto selected {fwd.backend}")

    def first(run):
        u = env["u"].clone().requires_grad_()
        out = run({**env, "u": u})
        (g,) = torch.autograd.grad(sum((o * o).sum() for o in out.values()),
                                   u, create_graph=True)
        return u, g

    def hvp(run):
        u, g = first(run)
        return torch.autograd.grad(g, u, v)[0]

    auto = lambda e: res.run(e, device=DEVICE)  # noqa: E731
    plain = lambda e: interior(res.plan, plan_run(e))  # noqa: E731
    u, g = first(auto)
    # the J^T step (the forward's adjoint for u) and the J v step (the
    # adjoint of that adjoint for its cotangent input)
    spec = adjoint_build(case.program).spec_for("u")
    steps = {"J^T": spec.result().plan}
    for st in case.program.body:
        s = adjoint_build(spec.program).spec_for(COTANGENT_PREFIX
                                                 + st.lhs.name)
        steps[f"J v ({s.input})"] = s.result().plan
    cache = executor_cache()
    for ex in cache.executors():  # counts zeroed just before the run
        ex.calls = ex.batch_calls = 0
        if ex.spec is not None:
            ex.spec.launches = 0
    (h,) = torch.autograd.grad(g, u, v)
    torch.cuda.synchronize()
    ran = [ex for ex in cache.executors() if ex.calls + ex.batch_calls]
    off = [plan_hash(ex.plan) for ex in ran if ex.backend != "hopper"]
    if off:
        raise SystemExit(f"hvp: the second backward ran plans {off} off K1")
    launches = {name: sum(ex.kernel_launches for ex in ran
                          if plan_hash(ex.plan) == plan_hash(pl))
                for name, pl in steps.items()}
    if min(launches.values()) < 1:
        raise SystemExit(f"hvp: a step of the second backward launched no "
                         f"K1 kernel: {launches}")
    second = sum(ex.kernel_launches for ex in ran)
    want = hvp(plain)
    torch.cuda.synchronize()
    tol = default_tolerances(dt)["grad"]
    err = rel_err({"u": h}, {"u": want})
    if h is None or err > tol:
        raise SystemExit(f"hvp: auto vs torch {err:.2e} > {tol:.0e}")
    del u, g, h, want
    auto_ms = _time_ms(lambda: hvp(auto), torch)
    plain_ms = _time_ms(lambda: hvp(plain), torch)
    print(f"hvp {case.name} {np.dtype(dt).name} {tuple(env['u'].shape)}: "
          f"K1 launches in the second backward {second} {launches}, "
          f"executors {len(ran)}, all on K1, hvp_ms "
          f"{auto_ms:.4f} (forward, backward with create_graph, backward), "
          f"plain autograd of the torch evaluator ms {plain_ms:.4f}, vs "
          f"torch {err:.2e} (<= {tol:.0e})", flush=True)


def full_size_cells():
    """The four cells of phases 4 and 6: (case, dtype)."""
    import numpy as np

    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm

    return [(get_case("j3d27pt", 512), np.float32),
            (get_case("poisson", 512), np.float32),
            (get_case("derivative", 256), np.float64),
            (pop_hdifft_gm(8192, 8192), np.float32)]


def tile_sweep(torch) -> None:
    """``--tile-sweep``: the stencil kernel of each full-size cell at the
    plane tiles of :data:`TILE_SWEEP`, each checked against ``"torch"``
    within ``plan``, then timed (median of 10 after a warm-up)."""
    import numpy as np

    from repro_torch import compile_plan, race
    from repro_torch.core.codegen import required_shapes
    from repro_torch.kernels.build import compile_sources
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.lowering.facts import LoweringError
    from repro_torch.testing import build_env, default_tolerances, rel_err

    runs = []
    for case, dt in full_size_cells():
        res = race(case.program, reassociate=case.reassociate)
        shapes = required_shapes(case.program)
        dname = np.dtype(dt).name
        for rows, cols, inner in TILE_SWEEP[case.name]:
            try:
                spec = specialize_stencil(res.plan, shapes,
                                          {k: dname for k in shapes}, rows,
                                          cols, inner)
            except LoweringError as e:
                print(f"tile-sweep {case.name} {(rows, cols, inner)}: "
                      f"refused ({e})", flush=True)
                continue
            runs.append((case, dt, res, spec))
    t0 = time.time()
    compile_sources([spec.source for *_, spec in runs])
    print(f"tile-sweep build: {len(runs)} sources in {time.time() - t0:.1f} "
          f"s", flush=True)
    failures = 0
    for name in TILE_SWEEP:
        group = [r for r in runs if r[0].name == name]
        case, dt, res = group[0][:3]
        outs = {st.lhs.name for st in case.program.body}
        env = {k: torch.as_tensor(v, device=DEVICE)
               for k, v in build_env(case, dt, seed=0).items()
               if k not in outs}
        plain = compile_plan(res.plan, env, "torch")(env)
        tol = default_tolerances(dt)["plan"]
        for *_, spec in group:
            got = spec(env)
            torch.cuda.synchronize()
            err = rel_err(got, plain)
            del got
            g, tp = spec.tp.geometry, spec.tp
            ms = _time_ms(lambda: spec(env), torch)
            ok = err <= tol
            failures += not ok
            print(f"tile-sweep {name} {np.dtype(dt).name}: plane tile "
                  f"{tuple(g.tile[l - 1] for l in g.order)} (levels "
                  f"{g.order}), segment {g.seg}, "
                  f"blocks {g.n_tiles}, threads {g.threads}, smem "
                  f"{tp.smem_bytes} B, aux_evals_per_point "
                  f"{tp.aux_evals_per_point:.3f}, kernel_ms {ms:.4f}, "
                  f"vs torch {err:.2e} {'ok' if ok else 'FAIL'}", flush=True)
        del env, plain
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"tile sweep: {failures} runs disagree with torch")


def tf32_sweep(torch) -> None:
    """``--tf32-sweep``: the 3xTF32 kernel (partials and combine, on parts
    split once) at the qwen2-7b head, rebuilt per (FLUSH, STAGES) of
    :data:`TF32_SWEEP`; three rounds in turn, each build timed (median of
    10 after a warm-up) with its error against the plain version and the
    float64 loss."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_ce as fc

    base = build.csrc_source("fused_ce.cu")
    own = TF32_CONSTANTS.format(stages=4, flush=8)
    if own not in base:
        raise SystemExit("tf32 sweep: Tf32x3Op's constants are not "
                         f"{own!r}; update TF32_CONSTANTS")
    sources = {c: base.replace(own, TF32_CONSTANTS.format(stages=c[1],
                                                          flush=c[0]))
               for c in TF32_SWEEP}
    t0 = time.time()
    build.compile_sources(list(sources.values()))
    print(f"tf32-sweep build: {len(sources)} sources in "
          f"{time.time() - t0:.1f} s", flush=True)
    libs = {c: build.load(src, fc._SYMBOLS) for c, src in sources.items()}
    T, D, V = CE_FULL["T"], CE_FULL["D"], CE_FULL["V"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h = torch.randn(T, D, generator=gen, device=DEVICE)
    w = torch.randn(D, V, generator=gen, device=DEVICE) * 0.05
    labels = torch.randint(0, V, (T,), generator=gen, device=DEVICE,
                           dtype=torch.int32)
    z = h.double() @ w.double()
    dense = torch.logsumexp(z, 1) - z.gather(1, labels.long()[:, None])[:, 0]
    del z
    plain = fc.fused_ce_forward_ref(h, w, labels, t_blk=T)
    hp, wp = fc.tf32_split(h), fc.tf32_split(w, transpose=True)
    width = fc.split_width(T, V, variant="tf32x3")
    n_split = -(-V // width)
    part = torch.empty((3, n_split, T), dtype=torch.float32, device=DEVICE)
    loss = torch.empty(T, dtype=torch.float32, device=DEVICE)

    def launch(lib):
        rc = lib.fused_ce_tf32x3_launch(
            hp[0].data_ptr(), hp[1].data_ptr(), wp[0].data_ptr(),
            wp[1].data_ptr(), hp.shape[2], labels.data_ptr(), T, D, V, width,
            n_split, part.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"tf32 sweep: launch failed, error {rc}")

    order = list(libs)
    for rnd in range(3):
        for c in order if rnd % 2 == 0 else order[::-1]:
            launch(libs[c])
            torch.cuda.synchronize()
            e_plain = float((loss - plain).abs().max() / plain.abs().max())
            e64 = float((loss.double() - dense).abs().max()
                        / dense.abs().max())
            ms = _time_ms(lambda: launch(libs[c]), torch)
            flush = "at tile ends" if c[0] > D // 16 else f"every {c[0]} slabs"
            print(f"tf32-sweep round {rnd} flush {flush}, stages {c[1]}: "
                  f"partials+combine ms {ms:.4f}, vs plain {e_plain:.2e}, "
                  f"vs float64 {e64:.2e}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    # the library yardsticks (cuDNN, cuBLAS) and the plain versions compute
    # in full float32; cuDNN picks its fastest algorithm during the warm-up
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    from repro_torch import compile_plan, race
    from repro_torch.apps import CASES, get_case
    from repro_torch.core.codegen import interior, required_shapes
    from repro_torch.kernels.build import compile_sources, csrc_source
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.lowering.geometry import kernel_analysis
    from repro_torch.testing import (SWEEP_SIZES, build_env,
                                     default_tolerances, env_to_torch,
                                     rel_err)

    t_start = time.time()
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    sweeps = {"--tile-sweep": tile_sweep, "--tf32-sweep": tf32_sweep}
    if len(sys.argv) == 2 and sys.argv[1] in sweeps:
        sweeps[sys.argv[1]](torch)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(smi)
        return 0

    # ---- plans of phases 3 and 4 ------------------------------------------
    sweep = []  # (case, level, dtype, RaceResult)
    for name in CASES:
        case = get_case(name, SWEEP_SCALE * SWEEP_SIZES[name])
        for lvl in sorted({0, case.reassociate}):
            res = race(case.program, reassociate=lvl,
                       rewrite_div=case.rewrite_div)
            for dt in (np.float32, np.float64):
                sweep.append((case, lvl, dt, res))
    main_runs = [(case, dt, race(case.program, reassociate=case.reassociate))
                 for case, dt in full_size_cells()]
    # the gradient sweep runs each case at its default level, in float32
    grad_cases = [(case, res) for case, lvl, dt, res in sweep
                  if lvl == case.reassociate and dt is np.float32]

    marks = [(1, t_start)]  # (phase, start) for the phase seconds
    # ---- phase 2: build ----------------------------------------------------
    marks.append((2, time.time()))
    sources = []
    for case, _, dt, res in sweep + [(c, None, d, r) for c, d, r in main_runs]:
        shapes = required_shapes(case.program)
        sources.append(specialize_stencil(
            res.plan, shapes, {k: np.dtype(dt).name for k in shapes}).source)
    for case, res in grad_cases:
        sources += adjoint_sources(case, res, np.float32)
    for case, dt, res in main_runs:
        sources += adjoint_sources(case, res, dt)
    batch_runs = [(label, case, dt, B, race(case.program,
                                            reassociate=case.reassociate))
                  for label, case, dt, B in batch_cells()]
    for _, case, dt, _, res in batch_runs:
        shapes = required_shapes(case.program)
        sources.append(specialize_stencil(
            res.plan, shapes, {k: np.dtype(dt).name for k in shapes}).source)
    # the batched gradient and the HVP (phases 9-10): j3d27pt n=256 f32
    sources += adjoint_sources(batch_runs[0][1], batch_runs[0][4],
                               np.float32)
    sources.append(csrc_source("fused_ce.cu"))
    t0 = time.time()
    compile_sources(sources)
    print(f"build: {len(set(sources))} kernel sources compiled in "
          f"{time.time() - t0:.1f} s", flush=True)

    # ---- phase 3: kernel vs plain version ----------------------------------
    marks.append((3, time.time()))
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
    marks.append((4, time.time()))
    kernels, schedules = [], []
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
        arrays = kernel_analysis(res.plan).arrays
        nbytes, ops = plan_work(res.plan, env, np.dtype(dt).itemsize)
        bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
        tp = ex.spec.tp
        geo = tp.geometry
        print(f"main {case.name} {dname} {tuple(env[next(iter(arrays))].shape)}"
              f": selection hopper, launches {launches}, stream level "
              f"{geo.s_level}, plane tile "
              f"{tuple(geo.tile[l - 1] for l in geo.order)} (levels "
              f"{geo.order}), segment {geo.seg}, warm-up {-geo.k0}, blocks "
              f"{geo.n_tiles}, ring depths "
              f"{ {r.name: r.depth for r in geo.rings} }, smem "
              f"{tp.smem_bytes} B, aux_evals_per_point "
              f"{tp.aux_evals_per_point:.3f}, kernel_ms {kernel_ms:.4f}, "
              f"torch_ms {torch_ms:.4f}, library_ms {library_ms}, "
              f"bytes {nbytes}, bound_ms {bound_ms:.4f} ({by}), "
              f"share of bound {bound_ms / kernel_ms:.3f}, max_abs_err "
              f"{max_abs:.3e}, rel_err {e_plan:.2e}", flush=True)
        kernels.append(dict(
            name=f"race_stencil[{case.name}]", route="cuda",
            source="src/repro_torch/lowering/emit.py",
            replaces="src/repro/lowering/emit.py:273",
            launches=launches, max_abs_err=max_abs, ms=kernel_ms,
            plain_ms=torch_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=library_ms))
        schedules.append(dict(
            name=f"race_stencil[{case.name}]", s_level=geo.s_level,
            plane_tile=[geo.tile[l - 1] for l in geo.order],
            plane_levels=list(geo.order), segment=geo.seg,
            ring_depths={r.name: r.depth for r in geo.rings},
            smem_bytes=tp.smem_bytes,
            aux_evals_per_point=tp.aux_evals_per_point))
        del env, ex, ex_t, lib
        torch.cuda.empty_cache()

    # ---- phase 5: gradient sweep -------------------------------------------
    marks.append((5, time.time()))
    failures = grad_sweep(grad_cases, torch)
    if failures:
        raise SystemExit("phase 5 failed:\n" + "\n".join(failures))

    # ---- phase 6: gradient at full size ------------------------------------
    marks.append((6, time.time()))
    for case, dt, res in main_runs:
        kernels.append(grad_full_size(case, dt, res, torch))
        torch.cuda.empty_cache()

    # ---- phase 7: fused cross-entropy sweep --------------------------------
    marks.append((7, time.time()))
    failures = ce_sweep(torch)
    if failures:
        raise SystemExit("phase 7 failed:\n" + "\n".join(failures))

    # ---- phase 8: fused cross-entropy at full width ------------------------
    marks.append((8, time.time()))
    kernels += ce_full_width(torch)

    # ---- phase 9: run_batch at full width, forward and gradient -----------
    marks.append((9, time.time()))
    for label, case, dt, B, res in batch_runs:
        kernels.append(batch_main(label, case, dt, B, res, torch))
        torch.cuda.empty_cache()
    label, case, dt, B, res = batch_runs[0]
    kernels.append(batch_grad(label, case, dt, B, res, torch))
    torch.cuda.empty_cache()

    # ---- phase 10: second order (a Hessian-vector product) -----------------
    marks.append((10, time.time()))
    hvp_check(case, dt, res, torch)

    marks.append((None, time.time()))
    print("phase seconds: " + ", ".join(
        f"{ph} {t1 - t0:.1f}" for (ph, t0), (_, t1) in zip(marks, marks[1:])))
    print(f"total seconds: {time.time() - t_start:.1f}")
    # the schedule each phase-4 kernel ran, from its TileProgram (worked
    # out, not measured)
    print(json.dumps({"schedule": schedules}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
