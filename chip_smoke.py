#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

  1. device: require CUDA; print ``nvidia-smi``'s name and power limit;
  2. build: render the stencil kernel of every plan below and compile them
     all with nvcc at once (one process per source) into build/repro_torch/;
     print the build seconds;
  3. kernel vs plain version: all 19 registry cases x reassociate {0,
     default} x float32/float64/float16/bfloat16 at three times the test
     sizes (a bfloat16 env is the float32 one rounded to nearest even) —
     the ``"hopper"`` backend against the ``"torch"`` backend on the card
     within the dtype's ``plan`` tolerance, both against the float64
     baseline program within ``baseline``, and the kernel's launch count
     must rise.  rhs_ph1 and rhs_ph2 overflow float16 at these sizes
     (:data:`F16_OVERFLOW`): there they are held where the baseline lies
     under :data:`FP16_HELD`.  Then the programs with constant
     subexpressions (``repro_torch/apps/constant_kernels.py``: ``sin(0.3)
     u[i]``, ``exp(0.1) u[i] + exp(0.1) u[i+1]``, ``log(-1.0) u[i]`` and
     the ``@race_kernel`` twin with ``math.sqrt(2.0)`` and
     ``math.exp(0.1)`` coefficients) at float64, K1 against ``"torch"``
     within ``plan`` (``log(-1.0)``: nan on both), and ``o[i] = 0.1``
     (K1 refuses it) on ``"torch"``, its output float64;
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
     output point (worked out from the tile program, not measured), and
     its registers, stack and spills (``cuobjdump``).  Then
     the half cells (:data:`HALF_CELLS`: j3d27pt and poisson n=512,
     hdifft_gm 8192x8192, each at float16 and bfloat16) the same way, each
     beside the bound of its 2-byte elements and, for j3d27pt, ``F.conv3d``
     at the same dtype, and timed in turns with the float32 kernel of the
     same case and plan (:func:`half_turns`: the half / float32 ratio);
  5. gradient sweep: the 19 cases at three times the test sizes, float32,
     ``torch.autograd.grad`` of a cosine-projection loss through
     ``res.run(env)`` against autograd of the float64 baseline program
     within ``grad``; the backend and probe codes of every adjoint run
     (each array spec, and the scalars as one group where there are two or
     more, ``adjoint_runs``) are printed, every run must be on the kernel
     and launch it once in the backward, and each scalar of a group must
     get, bit for bit, the gradient that group's launch gives it
     (:func:`group_gate`; refused adjoint builds print their code and take
     autograd).  Then the fault programs of ROADMAP F14 and F15
     (``repro_torch.testing.faults``, :data:`FAULT_CELLS`) at three times
     their test extent, float32, through ``"hopper"`` and ``"auto"``: each
     read input alone and all of them wanted, ``torch.autograd.grad``
     without ``allow_unused`` within ``grad`` of autograd of the float64
     baseline, the cancelled input's gradient exact zeros of its dtype and
     shape, and the backward's K1 launches one per wanted adjoint spec the
     probe admits (none on the autograd fallback);
  6. gradient at full size: the four cells of phase 4 and j3d27pt n=512 at
     float16, the backward through ``res.run`` timed (CUDA events, median
     of 10 after a warm-up), its kernel launches counted (zeroed just
     before; every adjoint run on K1, launched once, the group gate), the
     gradients held against the same adjoint plans on ``"torch"`` within
     ``plan`` (float16: ``grad``, as K1 computes in float32 and
     ``"torch"`` op by op in float16), and the adjoint kernels timed beside
     their bound and their ``"torch"`` time; the scalars' group timed in
     turns beside its members' own summed launches, one per scalar (as the
     backward ran them before the group), with the byte bounds of both
     ways, and j3d27pt's beside ``torch.nn.grad.conv3d_weight`` (its 27
     taps folded into the 5 scalars); last, the float16 backward's and
     adjoint kernels' times beside the float32 ones of the same cell (this
     run);
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
     each schedule is printed; the chooser's geometry for the batch is
     timed in turns against the long segments' (:func:`long_blocks`) or,
     where it is that, against the one it gives a single example
     (:func:`geometry_turns`).  Then ``torch.autograd.grad`` through
     ``run_batch`` for j3d27pt_b8: each adjoint run's kernel (the ``u``
     spec's and the scalars' group's) launches once for the batch, the
     group gate holds, each example's gradient is held against ``run``'s
     within ``grad``, and the batched backward, a loop of B backwards and
     the adjoint kernels are timed;
 10. second order: a Hessian-vector product of ``sum(run(u)**2)`` for
     j3d27pt n=256 f32 on ``"auto"`` against plain autograd of the
     ``"torch"`` evaluator within ``grad``; every executor of the second
     backward must be K1's, and its J^T step (the forward's adjoint) and
     its J v step (the adjoint of that adjoint) must each launch; both
     products are timed;
 11. the capture frontend (:func:`twin_cells`): each plain-Python twin of
     ``apps/frontend_kernels.py`` wrapped in ``race_kernel`` and run on
     ``"auto"`` at full size (calc_tpoints and hdifft_gm 8192x8192,
     psinv, resid and j3d27pt n=512, poisson n=512, all f32).  The
     selection must be ``"hopper"`` with exactly one launch (zeroed just
     before), the output bit-equal to ``race(case.program).run(env)`` on
     the card, with the same plan hash and source digest, and within
     ``baseline`` of the float64 baseline program; the kernel is timed
     beside its plain version, the library call where there is one and
     its bound, and printed beside the cell's phase-4 time.  Then, with
     ``obs.configure(enabled=True)``, the j3d27pt twin is captured,
     traced, run three times and differentiated (fresh executors and
     adjoint build), ``obs.dump`` writes ``build/obs/OBS_metrics.json``,
     and ``python -m repro_torch.obs.report`` must find every span of
     :data:`OBS_SPANS` (it writes the Chrome trace
     ``build/obs/OBS_trace.json`` and prints the span summary).  Last,
     the host's µs per call of 256 calls each of the executor's ``run``,
     ``res.run`` and ``race_kernel.run`` on one j3d27pt_b256 example
     (n = 64) with obs off and on, in turns (off, on, on, off, twice),
     and the medians;
 12. the autotuner (``repro_torch.tuning``) on a fresh store (the script
     points ``$RACE_TUNING_CACHE`` at ``build/smoke_tuning/`` before phase
     1, so phases 1-11 hold ``"auto"`` to the kernel on an empty store):
     ``autotune`` of j3d27pt and poisson n=512 f32 over levels {0, the
     case's default} x {``"torch"``, ``"hopper"``} x the port's tile grid
     (every candidate's K1 source built in phase 2), and of j3d27pt n=64
     f32 per call and at batch sizes 8 and 32.  Every candidate's status,
     rel_err and µs are printed, then the default's µs, the winner, the
     search seconds and K1's launches per kernel candidate.  The winner
     must pass the gate and not be slower than the default beyond the 3 %
     noise margin; a fresh process (``chip_smoke.py --store-hit``) must
     answer every cell from the store with no measurement and no nvcc run,
     and build each winner's executor on ``"auto"`` with its plan record's
     blocks, launching K1 once.  Then ``race(program).run(env)`` on
     ``"auto"`` with real data must launch K1 once and agree with
     ``"torch"`` within ``plan``; the tuned kernel is timed beside the
     chooser's, ``"torch"``, the library call and the bound.  Last, the
     host's µs per ``compile_plan`` and ``res.run`` on ``"auto"`` (which
     consults the store) beside ``"hopper"`` (which does not);
 13. the serving runtime (``repro_torch.serve``) on ``"auto"`` with
     closed-loop client threads, on one example of j3d27pt_b256 (n=64
     f32) and of derivative_b8 (n=128 f64, per-example scalars) per
     request, at concurrency 1, 8 and 32 and max_batch 8 and 32, 512
     requests each (derivative 128 at concurrency 32 and max_batch 32, 64
     at its other settings: :data:`SERVE_LONG`, :data:`SERVE_SHORT`):
     every response bit-equal to ``res.run`` of its env on the card, K1's
     launches (zeroed just before) equal to the runtime's batches, nothing
     rejected; p50/p95 µs, rps, batches and coalesced beside a plain loop
     of as many ``res.run`` with its copy to the host; one batch of 32, on the executor the
     runtime resolves for it, split into host stack, host-to-device copy,
     K1 (CUDA events), device-to-host copy and fan-out, held against its
     plain version within ``plan``, and its K1 timed beside that plain
     version, the library call and the bound, and its geometry at 8 and
     32 examples in turns as in phase 9.  Last, fresh
     processes run ``python -m repro_torch.serve.warm`` on phase 12's
     store under ``PYTHONHASHSEED=4`` (a seed under which the reference
     derives another j3d27pt plan, ROADMAP F7; every record warmed, none
     unmatched, no nvcc run) and
     ``python -m repro_torch.launch.serve --case j3d27pt --n 64`` (its
     row printed);
 14. sharded execution (``repro_torch.shard``) on a 2x2 mesh: four
     distinct cards where there are four, else ``["cuda:0"] * 4`` (one
     controller, four shards on one card).  j3d27pt and poisson n=512 f32
     (each level extent, 510, splits in two) through ``race(...,
     mesh=mesh, halo=h).run(env)`` for h = ``"exchange"``,
     ``"recompute"`` and ``"auto"``: the local backend must be
     ``"hopper"``, K1 must launch once per shard (4 per call, zeroed just
     before), and the outputs must be within ``plan`` of the single-device
     kernel and within ``baseline`` of the float64 baseline program; the
     partition, the local plan hash, halo, restack and slab bytes and the
     strategy ``"auto"`` picked are printed, and the sharded call is timed
     (CUDA events, median of 10 after a warm-up; the host clock with every
     card synchronized when the shards span cards) beside the
     single-device ``res.run``, then split into its prologue (local slabs
     and halo copies), the four K1 launches, the epilogue (local interiors
     into the global outputs), the local plans on ``"torch"``, the bound
     and (j3d27pt) ``F.conv3d`` of the whole grid.  Then
     ``torch.autograd.grad`` through the sharded ``run`` of poisson
     against the single-device one within ``grad``: every adjoint spec
     sharded (4 launches) or fallen back (1) and on K1, both backwards
     timed; the fault programs of :data:`SHARD_FAULT_CELLS` differentiated
     through ``run_sharded`` as phase 5 differentiates them; rprj3 must
     raise ``ShardingUnavailable`` with ``shard-strided``; last, a 1 GiB device-to-device copy is timed (and
     a peer copy from card 0 to card 1 where there are two cards).  The
     local plans' sources (forward and adjoint) are built in phase 2;
 15. the LM stack (``repro_torch.models``) on the card.  ``lm:qwen2-7b``:
     qwen2-7b at full width and depth in bfloat16 with
     ``race_smooth_radius=2``, random weights and nonzero taps from a seeded
     generator; the mixer at the prefill's shape (``sx`` 516 x 14,336
     float32) on K1 against ``"torch"`` within ``plan`` and against
     ``F.conv1d`` (the library call) within ``baseline``, each timed
     beside the bound; ``prefill_logits`` of a batch of 4 x 512 random
     tokens must launch K1 exactly once (counted on the mixer's executor,
     zeroed just before) and agree with the same prefill on a ``"torch"``
     mixer (argmax on every row, max |diff| <= 3e-2 x max |logit|, the
     repo's bfloat16 model tolerance: the two mixers differ by ~1e-7 in
     float32, which the bfloat16 residual stream rounds and 28 layers
     amplify); then
     the prompt is decoded teacher-forced into ``init_caches(cfg, 4, 544)``
     and 32 greedy ``decode_step``s are timed one by one.  Prefill ms and
     tok/s beside the bound of its operations, decode p50 / p90 µs and
     tok/s beside the bound of the weights' bytes, and K1's share of the
     prefill are printed.  ``lm:parity``: full width at float32, depth cut
     to 4 layers, zero taps: teacher-forced decode of a 32-token prompt
     reproduces ``forward_hidden``'s last-position logits within 1e-3 x
     max |logit|.  ``lm:families``: every architecture's ``reduced()``
     config at float32 (MoE at capacity E): prefill and 4 decode steps
     finite, teacher-forced decode equal to the prefill (the reference's
     ``tests/test_arch_smoke.py`` check) for the decoding families but
     vlm, hubert prefill only; qwen2's reduced config with
     ``race_smooth_radius=2`` launches K1 once in its prefill.  The
     mixers' K1 sources are built in phase 2;
 16. the LM training path on the card.  ``lm:train:qwen2-7b``: qwen2-7b
     at full width in bfloat16, depth cut to 4 layers, the RACE mixer at
     radius 2, built by ``repro_torch.launch.train``'s ``setup`` (4 x 512
     synthetic tokens, AdamW at 3e-4, its chunk defaults) and trained 6
     steps through ``Trainer``; K1's launch counts (zeroed just before) on
     the mixer's forward and on each adjoint run's executor (``sx``'s, and
     the three taps' group) must equal the steps, every adjoint run must
     be on K1, every loss finite; the mixer's gradients with respect to
     ``sx`` and the taps at the step's shape on K1 against ``"torch"``
     within ``grad``, each tap's bit for bit its group's (the group
     gate); the step's ms
     (median of steps 2-6, synchronized), tokens/s, peak memory, the bound
     (operations: 6 flop per matrix weight and token plus the causal
     attention's at 989 TFLOP/s; bytes: AdamW's reads and writes) and its
     share, K1's forward ms and summed adjoint ms per step, the final
     checkpoint's bytes and seconds (kept for phase 17) and one step's device
     idle share (``torch.profiler``).  ``lm:train:resume``: qwen2-7b's
     reduced config in float32 with the mixer: 6 steps straight against 3,
     a new trainer on fresh parameters resuming from the checkpoint, and 3
     more: parameters and optimizer state bit-equal, the loss at step 6
     below step 1.  The mixers' forward and adjoint sources are built in
     phase 2;
 17. the LM's placement layer on the card.  Elastic: phase 16's final
     lm:train:qwen2-7b checkpoint (the trainer freed first) re-sharded by
     ``runtime.elastic.reshard_checkpoint`` onto a 2x2 (``data``,
     ``model``) mesh of cuda:0 (:data:`ELASTIC_MESH`), every parameter and
     moment placed per ``params_shardings`` / ``opt_state_shardings``, then
     gathered back leaf by leaf and compared with the checkpoint's arrays
     bit for bit; the seconds, the bytes on the card and the largest
     shard's bytes are printed, and the checkpoint is deleted.  Grad sync:
     four members of a ``data`` axis on cuda:0, each holding the float32
     gradient of one qwen2-7b layer unit at full width (233 M parameters)
     from its own pipeline batch (4 x 512 tokens); two rounds of
     ``runtime.grad_sync.compressed_pmean_tree``, the second fed the
     first's error: the mean within 0.02 of the exact one (the reference's
     test's bound), the members bit-equal, ``m1 + m2 = 2 exact - mean(e2)``
     within float32 rounding (the carried error is used); each round's ms
     and the int8 bytes on the wire against the float32 bytes a plain
     mean would move are printed.

 18. the LM on a 2x2 (``data``, ``model``) mesh of cuda:0 four times
     (``repro_torch.models.spmd``: FSDP gathers, tensor parallel over
     ``model`` for attention, MLPs, MoE experts, Mamba and RG-LRU channels,
     the batch and MoE capacity over ``data``).  ``mesh:train:qwen2-7b``
     (phase 16's cell) and ``mesh:train:deepseek-moe-16b`` (full width, 4
     layers: :data:`MOE_TRAIN_ARGV`) through ``launch.train --mesh 2x2
     --devices cuda:0,...``, 6 steps each (no checkpoint written): every
     step's loss within :data:`MESH_LOSS_TOL` of the same model's
     one-device step's from the same initialization and batches (the 6
     one-device steps run first, timed), the loss falling, K1 once a step
     on every position (an ``spmd_mixer`` span per position in
     ``repro_torch.obs``) and its launch counts (zeroed just before) on the
     forward and every adjoint run (``sx``'s and the taps' group) 4 per
     step; the position's mixer on
     K1 against ``"torch"`` (``plan``; gradients ``grad``); step ms beside
     the one-device step's, peak memory and the transfer log's bytes by
     kind, and the dry run's activation term at the cell's shapes (four
     positions') beside the measured peak less the bytes allocated before
     the steps, with their ratio (printed, not gated);
     for the MoE cell a position's expert buffer (E, C / R, F / M), gated
     on the experts' partial outputs being summed over ``model``.
     ``mesh:prefill`` of qwen2-7b (phase 15's prefill at full depth),
     falcon-mamba-7b and recurrentgemma-9b (full width, depth cut:
     :data:`MESH_RECURRENT`) on the mesh against one device's (argmax,
     3e-2 of the largest), K1 once per position, the activation term
     beside the prefill's measured peak as for training.
     ``mesh:parity``: phase 15's parity model and both recurrent
     families (float32, full width, :data:`MESH_PARITY_UNITS` layer
     units) on the mesh, decode against prefill within 1e-3.  K1 against
     ``F.conv1d`` and ``torch.mv`` at mesh positions' mixer shapes
     (:data:`MIXER_CONV_CHANNELS`) and the full-width mixer, the forward,
     the ``sx`` adjoint and the tap adjoints (their group's one summed
     launch, and each tap's own as before the group), each but the group
     also at long segments (:func:`long_blocks`), every geometry printed,
     timed in
     turns one call at a time and queued behind a spin
     (:func:`mixer_vs_conv1d`).  The ``launch.train --mesh ...
     --devices`` CLI on the reduced config with the mixer; one
     ``launch.dryrun`` record
     (qwen2_7b x train_4k on the 16x16 pod, meta devices).  Its mixers'
     K1 sources are built in phase 2.  Every mesh step runs the
     sequence-parallel residual (the default: a member holds its S / M
     tokens between layer units);
     mesh:train:qwen2-7b runs again with ``--no-seq-parallel`` (the
     replicated residual, :data:`MESH_LAYOUT_CELLS`), and
     ``mesh:layouts`` prints both layouts' step ms, peak memory, transfer
     bytes by kind, the bytes the units' remat saved a position
     (``saved_tensors_hooks``) and step-1 losses, gated on the losses
     (:data:`MESH_LAYOUT_TOL`) and on the saved bytes falling by M.  The
     mesh cells' kernel lines split K1's adjoints into the ``sx`` adjoint
     (timed beside ``F.conv1d`` with the reversed filter) and the tap
     adjoints (timed beside one ``torch.mv`` over ``sx``'s shifted rows
     and one ``F.conv1d`` of ``sx`` with the output gradient as a single
     filter across the channels, whose R + 3 lags give every tap:
     :func:`tap_adjoint_library_call`, each held against K1 within
     ``plan`` of ``sum |g b|``; the kernel line's library time is mv's);
     ``mixer vs conv1d`` times both adjoints in turns too.

The last lines are the phase-4 schedules as JSON (``{"schedule": [...]}``),
the kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Imports no jax and nothing of the JAX
package ``repro``.

    python3 chip_smoke.py --tile-sweep

times the stencil kernel instead at forced plane tiles (and, for the 2-D
cell, segment lengths) on the full-size cells of
phase 4, each checked against ``"torch"`` first: the sweep the tile chooser
(``lowering/blocks.py``) is set from.

    python3 chip_smoke.py --mixer-sweep

times K1 instead on the LM mixer (the forward, the ``sx`` adjoint and the
summed ``sw0`` adjoint at ``sx`` 516 x 2,048, 3,584 and 14,336) at every
(segment, plane width) of :data:`MIXER_SWEEP_SEGMENTS` x
:data:`MIXER_SWEEP_WIDTHS` and at the chooser's own, each checked against
``"torch"`` first, one call at a time and queued, beside ``F.conv1d`` /
``torch.mv``: the sweep the chooser's short-stream segments
(``SHORT_SEGMENT``) are set from.

    python3 chip_smoke.py --lm

runs phases 1, 2 (the mixers' sources only) and 15 alone.

    python3 chip_smoke.py --train

runs phases 1, 2 (the training mixers' sources only) and 16 alone.

    python3 chip_smoke.py --shard

runs phases 1, 2 (the training mixers' sources only), 16 and 17 (which
re-shards 16's checkpoint).

    python3 chip_smoke.py --mesh

runs phases 1, 2 (the mesh's mixer sources only) and 18 alone.

    python3 chip_smoke.py --step-turns PARENT [ROUNDS]

times K1 instead at :data:`STEP_CELLS` (phase 4's cells, j3d27pt's and
poisson's level-0 plans, the scalars' groups of phase 6, and the LM
mixer's forward, ``sx`` adjoint and taps' group) in the tree at PARENT (a
``git archive`` of another commit, unpacked under the ignored ``build/``)
and in this tree, in turns, each turn a fresh process: the parent's
kernel beside the new one on one card, one call at a time and queued.

    python3 chip_smoke.py --tf32-sweep

times K4's 3xTF32 kernel instead at the qwen2-7b head, rebuilt with the
flush periods and ring depths of :data:`TF32_SWEEP` in place of its own,
each with its error against the plain version and the float64 loss: the
sweep ``Tf32x3Op``'s constants (``csrc/fused_ce.cu``) are set from.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core
#: flop/s per dtype (K1 computes float16 and bfloat16 in float32, so theirs
#: is float32's), and the dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "float16": 67e12,
              "bfloat16": 67e12}
#: bytes of an element in device memory
ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}
#: the half dtypes K1 takes (phases 3, 4 and 6)
HALF_DTYPES = ("float16", "bfloat16")
#: phase 4's half cells: (case, n), each at both half dtypes
HALF_CELLS = (("j3d27pt", 512), ("poisson", 512), ("hdifft_gm", 8192))
#: phase 4's float32 cells whose level-0 plan is timed in turns beside
#: the default plan (:func:`level0_turns`)
LEVEL0_CELLS = ("j3d27pt", "poisson")
#: phase 3's float16 cells whose outputs overflow float16 at three times the
#: test sizes (rhs_ph1 and rhs_ph2 reach 9.6e5 > 65504): held where the
#: float64 baseline lies within FP16_HELD.  The reference's own float16 sweep
#: at these sizes reports them at 0 error only because its rel_err's max
#: drops the NaN of inf - inf
F16_OVERFLOW = ("rhs_ph1", "rhs_ph2")
FP16_HELD = 32768.0
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 494.5e12
SWEEP_SCALE = 3
REPS = 10
#: phase 3's programs with constant subexpressions
#: (``repro_torch/apps/constant_kernels.py``): their extent, at float64
CONST_N = 1 << 16
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
#: ``--mixer-sweep``: K1 on the mixer's forward, ``sx`` adjoint and summed
#: ``sw0`` adjoint at every (segment, plane width) of these, plus the
#: chooser's own, at ``sx`` 516 x each of MIXER_CONV_CHANNELS and the
#: full-width mixer's channels
MIXER_SWEEP_SEGMENTS = (2, 3, 4, 5, 6, 8, 16, 32)
MIXER_SWEEP_WIDTHS = (32, 64, 128, 256, 1024)
#: rounds of (other, new, new, other) turns of :func:`geometry_turns`
GEOMETRY_ROUNDS = 3
#: ``--step-turns``: K1's cells timed in turns against another tree's
#: kernel: (case, n, dtype, level) with level None for the case's default,
#: 0, or "scalars" for the scalars' group of its backward; and the LM
#: mixer's ("mixer", C, "float32", run) at ``sx`` 516 x C for C of
#: MIXER_CONV_CHANNELS and the full width (batch 4 x d_model 3,584), run
#: the forward, the ``sx`` adjoint or the taps' group
STEP_CELLS = (("j3d27pt", 512, "float32", None), ("j3d27pt", 512, "float32", 0),
              ("poisson", 512, "float32", None), ("poisson", 512, "float32", 0),
              ("derivative", 256, "float64", None),
              ("hdifft_gm", 8192, "float32", None),
              ("j3d27pt", 512, "float16", None),
              ("j3d27pt", 512, "bfloat16", None),
              ("poisson", 512, "float16", None),
              ("poisson", 512, "bfloat16", None),
              ("hdifft_gm", 8192, "float16", None),
              ("hdifft_gm", 8192, "bfloat16", None),
              ("j3d27pt", 512, "float32", "scalars"),
              ("j3d27pt", 512, "float16", "scalars"),
              ("poisson", 512, "float32", "scalars"),
              ("derivative", 256, "float64", "scalars")) + tuple(
    ("mixer", C, "float32", run) for C in (3584, 2048, 4 * 3584)
    for run in ("forward", "sx", "taps"))
#: ``--step-turns``' rounds of (parent, new, new, parent) turns
STEP_ROUNDS = 2
#: calls enqueued back to back behind a spin kernel per queued timing
#: (:func:`_queued_ms`)
QUEUE_CALLS = 50
#: ``--tf32-sweep``: (FLUSH, STAGES) of the 3xTF32 kernel; a FLUSH past the
#: 224 slabs of D = 3584 flushes once, at each tile's end
TF32_SWEEP = [(8, 4), (16, 4), (32, 4), (1 << 20, 4), (8, 3), (8, 5)]
#: the spans phase 11's traced run must record (``--require-spans``)
OBS_SPANS = ("capture,detect,contract,lower,compile,run,adjoint_build,"
             "adjoint_backward")
#: ``run`` calls per obs setting in phase 11's host-cost measurement
OBS_CALLS = 256
#: phase 12: (case, n) tuned at float32 over levels {0, the case's
#: default}, and the serving cell tuned per call and at these batch sizes
TUNE_CELLS = (("j3d27pt", 512), ("poisson", 512))
TUNE_SERVE_CELL = ("j3d27pt", 64)
TUNE_BATCH_SIZES = (8, 32)
#: phase 13: (label, case, n, dtype name, distinct envs the clients cycle
#: through); one example of a phase-9 cell per request
SERVE_CELLS = (("j3d27pt_b256", "j3d27pt", 64, "float32", 32),
               ("derivative_b8", "derivative", 128, "float64", 8))
SERVE_CONCURRENCY = (1, 8, 32)
SERVE_MAX_BATCH = (8, 32)
#: requests per setting and in the plain loop: 512; derivative's 185 MiB
#: per request through pageable memory serve about 10 a second (PERF.md
#: §5), so it takes 128 at SERVE_FULL (its percentiles of record) and in
#: its plain loop, and 64 at its other settings (the script's time limit)
SERVE_REQUESTS = 512
SERVE_FULL = (32, 32)  # (concurrency, max_batch)
SERVE_LONG = {"derivative_b8": 128}
SERVE_SHORT = {"derivative_b8": 64}
#: phase 14: (case, n) run sharded on a 2x2 mesh at float32 (every level
#: extent, 510, splits in two), the gradient cell
SHARD_CELLS = (("j3d27pt", 512), ("poisson", 512))
SHARD_GRAD_CELL = ("poisson", 512)
#: phase 5's fault programs (``repro_torch.testing.faults``, ROADMAP F14
#: and F15) at three times their test extent: (program, level, backends).
#: f14_mixed's forward cannot take K1 (mixed strides), so it runs on
#: ``"auto"`` only; its unit-stride twin, on the forced autograd fallback,
#: takes ``"hopper"``
FAULT_CELLS = (("f14_strided", 3, ("hopper", "auto")),
               ("f14_mixed", 3, ("auto",)),
               ("f14_unit", 3, ("hopper", "auto")),
               ("f15_sin", 0, ("hopper", "auto")),
               ("f15_scalar", 3, ("hopper", "auto")),
               ("f15_scalar", 4, ("hopper", "auto")))
#: phase 14's fault programs run sharded: (program, level, wanted inputs)
SHARD_FAULT_CELLS = (("f14_strided", 3, ("A",)), ("f15_sin", 0, ("B",)),
                     ("f15_sin", 0, ("A", "B")))
#: phase 15: the LM at full width (src/repro_torch/configs/qwen2_7b.py) with
#: the RACE mixer at examples/train_lm.py's default radius; batch, prompt
#: and generated tokens; the parity cell's depth and prompt; decode steps
#: of the family cells
LM_ARCH = "qwen2_7b"
LM_RADIUS = 2
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
LM_PARITY_LAYERS, LM_PARITY_PROMPT, LM_PARITY_BATCH = 4, 32, 2
LM_FAMILY_STEPS = 4
#: the prefill logits on K1's mixer against the torch mixer's, relative to
#: the largest: the bfloat16 tolerance of tests/test_torch_models.py (TOL)
LM_LOGITS_TOL = 3e-2
LM_FAMILY_SHAPE = (2, 16)  # (batch, prompt) of the reduced configs
#: phase 16: ``launch.train``'s arguments of lm:train:qwen2-7b (the
#: checkpoint directory is added under build/), and lm:train:resume's
#: batch, sequence, steps (checkpointed every TRAIN_RESUME_EVERY) and lr
TRAIN_ARGV = ["--arch", LM_ARCH, "--num-layers", "4", "--batch", "4",
              "--seq", "512", "--steps", "6", "--race-smooth", str(LM_RADIUS),
              "--lr", "3e-4", "--ckpt-every", "100"]
TRAIN_RESUME = dict(batch=4, seq=512, steps=6, every=3, lr=1e-3)
#: phase 17: the mesh phase 16's checkpoint is re-sharded onto (data,
#: model), of cuda:0 four times; grad sync's members on one data axis and
#: each member's batch and sequence
ELASTIC_MESH = (2, 2)
GRAD_SYNC_MEMBERS = 4
GRAD_SYNC_BATCH = (4, 512)
#: phase 18: the LM on a 2x2 (data, model) mesh of cuda:0 four times;
#: mesh:train:qwen2-7b's step-1 loss against one device's, relative: the
#: mesh rounds each member's partial products to bfloat16 before summing
#: them (one more rounding, 2^-8 relative, per block and sum), a mean over
#: 2,048 tokens of log-sum-exp minus gold moves far less; and the CLI's run
MESH = (2, 2)
MESH_LOSS_TOL = 1e-2
#: the training cells phase 18 also runs on the replicated residual
#: (``--no-seq-parallel``) after the default sequence-parallel one; their
#: step-1 losses, relative: the layout changes no sum of the forward, so
#: the two agree to the card's run-to-run rounding, far inside this
MESH_LAYOUT_CELLS = ("qwen2-7b",)
MESH_LAYOUT_TOL = 1e-3
#: mesh:train:deepseek-moe-16b: deepseek-moe-16b at full width, depth cut
#: to 4 layers (the dense first one and three MoE; 28 layers, 16.4 B
#: parameters under AdamW, do not fit 80 GB), capacity 1.25 (its
#: default), phase 16's batch, sequence and steps; lr 1e-3 (phase 16's
#: resume cell's): at 3e-4 the fall of its loss over 6 steps of uniform
#: synthetic tokens is smaller than the spread between their batches'
#: losses, so the falling-loss gate read the batches, not the training
MOE_TRAIN_ARGV = ["--arch", "deepseek_moe_16b", "--num-layers", "4",
                  "--batch", "4", "--seq", "512", "--steps", "6",
                  "--race-smooth", str(LM_RADIUS), "--lr", "1e-3",
                  "--ckpt-every", "100"]
#: phase 18's training cells: (label, ``launch.train``'s arguments); each
#: one's one-device steps run in the same call
MESH_TRAIN_CELLS = (("qwen2-7b", TRAIN_ARGV),
                    ("deepseek-moe-16b", MOE_TRAIN_ARGV))
#: mesh:prefill of the recurrent families at full width: (label, arch,
#: layers), B = LM_BATCH x LM_PROMPT.  Depth cut from 64 and 38: a deep
#: random bfloat16 recurrent stack amplifies rounding (at 64 layers the
#: mesh's falcon-mamba logits were 5.5 off one device's, whose largest was
#: 5.1), so the prefill gate cannot tell a fault from rounding there; the
#: cell prints the model's own bfloat16 noise beside the gate, and 64
#: layers took 36 s
MESH_RECURRENT = (("falcon-mamba-7b", "falcon_mamba_7b", 2),
                  ("recurrentgemma-9b", "recurrentgemma_9b", 6))
#: timed prefills a recurrent cell takes (after a warm-up), each side
MESH_PREFILL_REPS = 3
#: mesh:parity of the recurrent families: float32, full width, layer units
MESH_PARITY_UNITS = 2
#: the mixer at mesh positions' shapes (channels of ``sx``: 2 examples x
#: d_model / 2 of qwen2-7b, then of deepseek-moe-16b) against F.conv1d:
#: rounds of calls each, alternating
MIXER_CONV_CHANNELS = (3584, 2048)
MIXER_CONV_ROUNDS, MIXER_CONV_CALLS = 5, 10
#: a side whose warm call takes longer (the tap adjoints' conv1d: cuDNN
#: has one output channel to spread) is timed once a round
MIXER_CONV_SLOW_MS = 10.0
MESH_CLI_ARGV = ["--arch", LM_ARCH, "--reduced", "--mesh", "2x2", "--steps",
                 "3", "--batch", "4", "--seq", "64", "--race-smooth",
                 str(LM_RADIUS)]
#: the constants of ``Tf32x3Op`` that ``--tf32-sweep`` replaces
TF32_CONSTANTS = ("  static constexpr int STAGES = {stages};\n"
                  "  static constexpr int FLUSH = {flush};")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, torch, reps: int = 0) -> float:
    """Median over ``reps`` (default REPS) of one call, timed with CUDA
    events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps or REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued_ms(fn, torch) -> tuple:
    """``(ms, ahead)``: the card's time per call of QUEUE_CALLS calls
    enqueued back to back behind ``torch.cuda._sleep``,
    timed with CUDA events around them.  The spin is sized from the host's
    enqueue time of one call so the host is ahead when the card starts:
    ``ahead`` says the start event had not completed once every call was
    enqueued.  Unlike :func:`_time_ms`, the host's time per call is not in
    the figure."""
    calls = QUEUE_CALLS
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * max(host_s, 2e-5) * (calls + 2)))
    start.record()
    for _ in range(calls):
        fn()
    ahead = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, ahead


def tile_blocks(tile: tuple):
    """The ``(block_rows, block_cols, block_inner)`` overrides that name
    every level of ``tile``, or None where they cannot (levels 2..m-1 of
    unequal width)."""
    if len(set(tile[1:-1])) > 1:
        return None
    if len(tile) == 1:
        return (0, 0, tile[0])
    return (tile[0], tile[1] if len(tile) > 2 else 0, tile[-1])


def long_blocks(geo):
    """The overrides (:func:`tile_blocks`) that give ``geo``'s plane tile
    with long segments: never under ``SEG_PER_WARMUP`` warm-ups, the
    chooser's rule for a grid that is not short, so that a short grid's
    geometry can be timed in turns against it; None where ``geo``'s
    segment is that one."""
    from repro_torch.lowering.blocks import SEG_PER_WARMUP, TARGET_BLOCKS

    s = geo.s_level
    if not s:
        return None
    extent = geo.extents[s - 1]
    want = -(-TARGET_BLOCKS // (geo.n_tiles // geo.nb[s - 1]))
    n_seg = max(1, min(want, extent // max(1, SEG_PER_WARMUP * -geo.k0)))
    tile = list(geo.tile)
    tile[s - 1] = -(-extent // n_seg)
    return None if tile[s - 1] == geo.seg else tile_blocks(tuple(tile))


def other_geometry(spec, batch: int) -> tuple:
    """``(name, overrides)`` of the geometry :func:`geometry_turns` times
    the chooser's for a launch of ``batch`` examples against: long
    segments' (:func:`long_blocks`) or, where the chooser's are those (a
    batch that fills the grid), the one the chooser gives one example;
    overrides None where both are the chooser's."""
    geo = spec.program(batch).geometry
    blocks = long_blocks(geo)
    if blocks is None and spec.tp.geometry != geo:
        return "one example's", tile_blocks(spec.tp.geometry.tile)
    return "long segments'", blocks


def geometry_sources(plan, shapes, dname: str, batch: int) -> list:
    """The sources a launch of ``batch`` examples and its
    :func:`geometry_turns` run: the chooser's for one example and for the
    batch, and the other geometry's."""
    from repro_torch.lowering.emit import specialize_stencil

    dtypes = {k: dname for k in shapes}
    spec = specialize_stencil(plan, shapes, dtypes)
    blocks = other_geometry(spec, batch)[1]
    return [spec.source, spec.source_for(batch)] + (
        [] if blocks is None else
        [specialize_stencil(plan, shapes, dtypes, *blocks).source])


def geometry_turns(label, plan, sig, batch: int, run, want, tol,
                   torch) -> None:
    """The chooser's geometry of ``plan`` for a launch of ``batch``
    examples against long segments' (:func:`long_blocks`) or, where the
    chooser's are those (a batch that fills the grid), against the
    geometry the chooser gives one example, on ``run(executor)``,
    all on K1: checked against ``want`` within ``tol``, then timed in
    turns (other, new, new, other per round, GEOMETRY_ROUNDS rounds, each
    turn :func:`_time_ms`); prints both geometries, the median of each
    side's turns and every turn."""
    from repro_torch import compile_plan
    from repro_torch.testing import rel_err

    new = compile_plan(plan, sig, "hopper", device=DEVICE)
    geo = new.spec.program(batch).geometry
    other, blocks = other_geometry(new.spec, batch)
    if blocks is None:
        print(f"geometry {label}: long segments, as before "
              f"({geometry_text(geo)})",
              flush=True)
        return
    old = compile_plan(plan, sig, "hopper", device=DEVICE,
                       block_rows=blocks[0], block_cols=blocks[1],
                       block_inner=blocks[2])
    errs = [rel_err(run(ex), want) for ex in (old, new)]
    torch.cuda.synchronize()
    if max(errs) > tol:
        raise SystemExit(f"geometry {label}: K1 at the {other} or the new "
                         f"geometry is {max(errs):.2e} off")
    turns = {other: [], "new": []}
    for _ in range(GEOMETRY_ROUNDS):
        for side in (other, "new", "new", other):
            ex = old if side == other else new
            turns[side].append(_time_ms(lambda: run(ex), torch))
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"geometry {label} on {_nvidia_smi()}: new "
          f"({geometry_text(geo)}) {med['new']:.4f} ms, {other} "
          f"({geometry_text(old.spec.program(batch).geometry)}) "
          f"{med[other]:.4f} ms, new / {other} "
          f"{med['new'] / med[other]:.3f}; turns new "
          f"{[round(t, 4) for t in turns['new']]}, {other} "
          f"{[round(t, 4) for t in turns[other]]}; vs want "
          f"{errs[1]:.2e} / {errs[0]:.2e}", flush=True)


def half_turns(label, ex, env, bound_ms, twin, torch) -> None:
    """Phase 4: a half cell's kernel (``ex`` on ``env``) timed in turns
    with the float32 kernel of the same case and plan (``twin``: its env
    and executor; the same geometry and arithmetic at twice the bytes):
    half, float32, float32, half per round, GEOMETRY_ROUNDS rounds, each
    turn :func:`_time_ms`.  Prints the median of each side's turns, the
    half / float32 ratio, the half kernel's share of its bound and every
    turn."""
    env32, ex32 = twin
    assert ex32.spec.tp.geometry == ex.spec.tp.geometry
    turns = {"half": [], "float32": []}
    for _ in range(GEOMETRY_ROUNDS):
        for side in ("half", "float32", "float32", "half"):
            turns[side].append(_time_ms(
                (lambda: ex(env)) if side == "half" else
                (lambda: ex32(env32)), torch))
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"turns {label} beside float32 on {_nvidia_smi()}: half "
          f"{med['half']:.4f} ms, float32 {med['float32']:.4f} ms, half / "
          f"float32 {med['half'] / med['float32']:.3f}, share of bound "
          f"{bound_ms / med['half']:.3f} (bound {bound_ms:.4f}); turns "
          f"half {[round(t, 4) for t in turns['half']]}, float32 "
          f"{[round(t, 4) for t in turns['float32']]}", flush=True)


def level0_turns(label, case, dt, env, ex, torch) -> None:
    """Phase 4: the case's level-0 plan (the least reassociation) on K1,
    checked against ``"torch"`` within ``plan``, timed in turns with the
    default plan's kernel ``ex`` (level 0, default, default, level 0 per
    round, GEOMETRY_ROUNDS rounds, each turn :func:`_time_ms`); prints
    each side's median, default / level 0, level 0's step and every
    turn."""
    from repro_torch import compile_plan, race
    from repro_torch.testing import default_tolerances, rel_err

    res0 = race(case.program, reassociate=0)
    ex0 = compile_plan(res0.plan, env, "hopper")
    ex0_t = compile_plan(res0.plan, env, "torch")
    err = rel_err(ex0(env), ex0_t(env))
    torch.cuda.synchronize()
    tol = default_tolerances(dt)["plan"]
    if err > tol:
        raise SystemExit(f"{label} level 0: K1 vs torch {err:.2e} > "
                         f"{tol:.0e}")
    del ex0_t
    turns = {"level 0": [], "default": []}
    for _ in range(GEOMETRY_ROUNDS):
        for side in ("level 0", "default", "default", "level 0"):
            turns[side].append(_time_ms(
                (lambda: ex0(env)) if side == "level 0" else
                (lambda: ex(env)), torch))
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"turns {label} default beside level 0 on {_nvidia_smi()}: "
          f"default {med['default']:.4f} ms, level 0 {med['level 0']:.4f} "
          f"ms, default / level 0 {med['default'] / med['level 0']:.3f}; "
          f"level 0 aux {len(ex0.spec.tp.aux_exprs)}, "
          f"{k1_step(ex0.spec.tp, ex0.spec.source)}; turns default "
          f"{[round(t, 4) for t in turns['default']]}, level 0 "
          f"{[round(t, 4) for t in turns['level 0']]}", flush=True)


def k1_step(tp, source: str) -> str:
    """A K1 kernel's step as the geometry gives it and the build compiled
    it: barriers a step, rounds of the block's threads a step and per
    output point of a plane, lane use, blocks an SM by shared memory, by
    registers and as the launch bounds ask, registers and spilled
    (local) bytes a thread (``cuobjdump``)."""
    import re

    from repro_torch.lowering import blocks

    g = tp.geometry
    res = k1_resources(source)
    regs = int((re.search(r"REG:(\d+)", res) or [0, 0])[1])
    spill = sum(int(v) for v in re.findall(r"(?:STACK|LOCAL):(\d+)", res))
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (blocks.SM_REGISTERS // per_warp // (g.threads // 32)
               if regs else 0)
    return (f"barriers/step {g.barriers}, rounds/step {tp.rounds_per_step} "
            f"({tp.rounds_per_point:.4f} per point), lane use "
            f"{tp.lane_use:.3f}, blocks/SM by smem {g.smem_blocks} by "
            f"registers {by_regs} (launch bounds {g.blocks}), registers "
            f"{regs}, spilled bytes {spill}")


def step_cell(cell, envs: dict, torch):
    """``(label, thunk, check, source, tile program)`` of one
    :data:`STEP_CELLS` cell on the card: the thunk runs K1 once, ``check``
    returns its rel_err against the ``"torch"`` backend and the tolerance
    (the forward's ``plan``; a group's partials summed, ``plan``, at half
    ``grad``; the mixer taps' sums within ``plan`` of the sum of the
    products' magnitudes, :func:`tap_adjoint_check`'s gate).  ``envs``
    holds the envs made so far, one per case and dtype."""
    import numpy as np

    from repro_torch import compile_plan, race
    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm
    from repro_torch.core.adjoint import ScalarGroup
    from repro_torch.testing import default_tolerances, rel_err, torch_env

    name, n, dname, level = cell
    if name == "mixer":
        return mixer_step_cell(n, level, envs, torch)
    case = pop_hdifft_gm(n, n) if name == "hdifft_gm" else get_case(name, n)
    dt = getattr(np, dname, None) or dname
    lvl = case.reassociate if level in (None, "scalars") else level
    label = (f"{name} {dname}" + ("" if level is None else
                                   f" level {level}" if level == 0 else
                                   " scalars"))
    outs = {st.lhs.name for st in case.program.body}
    key = (name, n, dname)
    if key not in envs:  # the cells of one case and dtype share it
        envs[key] = {k: v for k, v in torch_env(case, dt, 0, DEVICE).items()
                     if k not in outs}
    env = envs[key]
    res = race(case.program, reassociate=lvl)
    # a half group: K1 sums in float32, the "torch" plan op by op in the
    # half dtype (phase 6's rule)
    tol = default_tolerances(dt)["grad" if level == "scalars" and dname in
                                 HALF_DTYPES else "plan"]
    if level != "scalars":
        ex = compile_plan(res.plan, env, "hopper")
        ex_t = compile_plan(res.plan, env, "torch")
        return (label, lambda: ex(env),
                lambda: (rel_err(ex(env), ex_t(env)), tol), ex.spec.source,
                ex.spec.tp)
    keys = sorted(k for k, v in env.items() if v.is_floating_point())
    p = {k: env[k].clone().requires_grad_() for k in keys}
    g = cos_weights(res.run({**env, **p}, device=DEVICE), torch)
    unit, a, ex = next(x for x in adjoint_executors(case.program, env, g)
                       if isinstance(x[0], ScalarGroup))
    ex_t = compile_plan(unit.result().plan, a, "torch")

    def check():
        got = {k: v.sum() for k, v in ex.run_sum(a).items()}
        want = {k: v.sum() for k, v in ex_t.run_sum(a).items()}
        return rel_err(got, want), tol

    return (label, adjoint_call(unit, ex, a), check,
            ex.spec.source_for(1, True), ex.spec.program(1))


def mixer_step_cell(C: int, run: str, envs: dict, torch):
    """:func:`step_cell` of the LM mixer at ``sx`` (LM_PROMPT + R + 2) x
    ``C`` (float32, random bfloat16 tokens and taps from a seed): its
    forward, its ``sx`` adjoint or its taps' group, as the backward runs
    them (output gradient :func:`cos_weights`)."""
    from repro_torch import compile_plan
    from repro_torch.core.adjoint import ScalarGroup
    from repro_torch.models.ssm import _smooth_result, smooth_env
    from repro_torch.testing import default_tolerances, rel_err

    res = _smooth_result(LM_PROMPT, C, LM_RADIUS)
    key = ("mixer", C)
    if key not in envs:  # a shape's three runs share its env
        gen = torch.Generator(DEVICE).manual_seed(5)
        taps = 0.5 * torch.randn(LM_RADIUS + 1, generator=gen, device=DEVICE)
        x = torch.randn((2, LM_PROMPT, C // 2), generator=gen,
                        device=DEVICE, dtype=torch.bfloat16)
        env = {k: v for k, v in smooth_env(x, taps, LM_RADIUS).items()
               if k != "sy"}
        g = cos_weights(compile_plan(res.plan, env, "torch")(env), torch)
        envs[key] = env, adjoint_executors(res.program, env, g)
    env, adj = envs[key]
    label = f"mixer {C} {run}"
    tol = default_tolerances("float32")["plan"]
    if run == "forward":
        ex = compile_plan(res.plan, env, "hopper")
        ex_t = compile_plan(res.plan, env, "torch")
        return (label, lambda: ex(env),
                lambda: (rel_err(ex(env), ex_t(env)), tol), ex.spec.source,
                ex.spec.tp)
    unit, a, ex = next(x for x in adj if isinstance(x[0], ScalarGroup) == (
        run == "taps") and (run == "taps" or x[0].input == "sx"))
    ex_t = compile_plan(unit.result().plan, a, "torch")
    if run == "sx":
        return (label, adjoint_call(unit, ex, a),
                lambda: (rel_err(ex(a), ex_t(a)), tol), ex.spec.source,
                ex.spec.tp)

    def check():
        got = {k: float(v.double().sum()) for k, v in ex.run_sum(a).items()}
        want = ex_t(a)
        scale = max(float(v.double().abs().sum()) for v in want.values())
        return max(abs(got[k] - float(want[k].double().sum()))
                   for k in got) / scale, tol

    return (label, adjoint_call(unit, ex, a), check,
            ex.spec.source_for(1, True), ex.spec.program(1))


def k1_cells(torch) -> None:
    """``--k1-cells ROOT``: one turn of :func:`step_turns` in this process,
    on the ``repro_torch`` of the tree at ROOT: build every
    :data:`STEP_CELLS` source at once, check each cell against
    ``"torch"``, time it one call at a time (:func:`_time_ms`) and queued
    (:func:`_queued_ms`) and print one ``k1-cell`` JSON line per cell
    (this tree's geometry fields too where it has them)."""
    from repro_torch.kernels.build import compile_sources

    t0 = time.time()
    envs: dict = {}
    cells = [step_cell(c, envs, torch) for c in STEP_CELLS]
    compile_sources([c[3] for c in cells])
    print(f"k1-cells build {time.time() - t0:.1f} s", flush=True)
    for label, run, check, source, tp in cells:
        err, tol = check()
        torch.cuda.synchronize()
        if err > tol:
            raise SystemExit(f"k1-cells {label}: K1 vs torch {err:.2e} > "
                             f"{tol:.0e}")
        ms = _time_ms(run, torch)
        queued, _ = _queued_ms(run, torch)
        step = k1_step(tp, source) if hasattr(tp, "lane_use") else (
            k1_resources(source))
        print("k1-cell " + json.dumps(dict(label=label, ms=ms, queued=queued,
                                           err=err, step=step)), flush=True)
        torch.cuda.empty_cache()


def step_turns(parent: str, rounds: int, torch) -> None:
    """``--step-turns PARENT [ROUNDS]``: K1 at :data:`STEP_CELLS` in the
    tree at PARENT (a ``git archive`` of another commit, unpacked where
    ``.gitignore`` lists) and in this tree, each turn a fresh process
    (``--k1-cells``) so that the two packages never share one: ROUNDS
    (default :data:`STEP_ROUNDS`) rounds of (parent, new, new, parent).
    Prints every turn and, per cell, each side's median one call at a
    time and queued, the new one's ratio to the parent's and, within each
    side, the default level over level 0."""
    root = str(Path(__file__).resolve().parent)
    sides = [("parent", parent), ("new", root)]
    times: dict = {}
    fields: dict = {}
    for rnd in range(rounds):
        for side, tree in sides + sides[::-1]:
            cmd = [sys.executable, str(Path(root) / "chip_smoke.py"),
                   "--k1-cells", tree]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode:
                raise SystemExit(f"step turn {side} exited "
                                 f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-4000:]}")
            for ln in proc.stdout.splitlines():
                if ln.startswith("k1-cell "):
                    c = json.loads(ln[len("k1-cell "):])
                    times.setdefault((side, c["label"]), []).append(
                        (c["ms"], c["queued"]))
                    fields[side, c["label"]] = c["step"]
            print(f"step turn {rnd} {side}: {time.time() - t0:.1f} s "
                  f"({[ln for ln in proc.stdout.splitlines() if 'build' in ln]})",
                  flush=True)
    labels = [c for (sd, c) in times if sd == "parent"]
    med = {k: [statistics.median(t[i] for t in v) for i in (0, 1)]
           for k, v in times.items()}
    for label in labels:
        base = med["parent", label]
        print(f"step {label} on {_nvidia_smi()}: " + "; ".join(
            f"{side} {med[side, label][0]:.4f} ms "
            f"({med[side, label][0] / base[0]:.3f} of parent), queued "
            f"{med[side, label][1]:.4f} "
            f"({med[side, label][1] / base[1]:.3f}), turns "
            f"{[[round(x, 4) for x in t] for t in times[side, label]]}"
            for side, _ in sides), flush=True)
        for side, _ in sides:
            print(f"step {label} {side}: {fields[side, label]}", flush=True)
    for name in ("j3d27pt", "poisson"):
        for side, _ in sides:
            d, z = (f"{name} float32", f"{name} float32 level 0")
            print(f"step {name} {side}: default / level 0 "
                  f"{med[side, d][0] / med[side, z][0]:.3f}", flush=True)


def geometry_text(geo) -> str:
    """Blocks, plane tile, segment, threads and prefetch depth of a
    geometry (the kernel keeps one plane in flight: ``cp.async`` for step
    k + 1 is issued at step k)."""
    return (f"blocks {geo.n_tiles}, plane {geo.plane_points} "
            f"{tuple(geo.tile[l - 1] for l in geo.order)}, segment "
            f"{geo.seg} (warm-up {-geo.k0}), threads {geo.threads}, "
            f"prefetch 1 plane")


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


def plan_work(plan, env, itemsize: int, summed: bool = False) -> tuple:
    """``(bytes, operations)`` one run of ``plan`` must do: every kernel
    operand read once, every output written once (``summed``: one value
    per output, a scalar's adjoint); every body and aux operation once per
    point of its box."""
    from repro_torch.core.ir import count_ops
    from repro_torch.lowering.geometry import kernel_analysis

    arrays = kernel_analysis(plan).arrays
    n_in = sum(env[k].numel() for k in arrays) * itemsize
    vol = plan.program.volume()
    n_out = (1 if summed else vol) * len(plan.body) * itemsize
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


def unit_label(unit) -> str:
    """An adjoint run's name: its input, or its scalar group's members
    joined by ``+``."""
    return "+".join(s.input for s in unit.members)


def adjoint_sources(case, res, dt, batch: int = 1,
                    members: bool = True) -> list:
    """Kernel sources of the case's adjoint plans that ``"auto"`` sends to
    the kernel at the case's full shapes, built ahead of the backward (a
    scalar's: the summed kernel, which the backward runs), for launches of
    ``batch`` examples: the scalars' group's, which a backward of every
    input runs, and each spec's but, without ``members``, the group's
    members' (phase 6 times them beside the group)."""
    import numpy as np

    from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
    from repro_torch.core.backend import select_backend
    from repro_torch.core.codegen import required_shapes
    from repro_torch.lowering.emit import specialize_stencil

    shapes = required_shapes(case.program)
    dname = np.dtype(dt).name
    build = adjoint_build(case.program)
    group = build.scalar_group([s.input for s in build.specs])
    units = [s for s in build.specs
             if members or group is None or s not in group.members]
    out = []
    for unit in units + ([group] if group else []):
        plan = unit.result().plan
        adj = adjoint_env_shapes(unit, case.program, shapes)
        if select_backend(plan, "auto", [dname]).backend == "hopper":
            sp = specialize_stencil(plan, adj, {k: dname for k in adj})
            out.append(sp.source_for(batch, unit.scalar))
    return out


def adjoint_call(unit, ex, a, batched: bool = False):
    """A thunk of the call the backward makes of one adjoint program's
    executor: a scalar's or a scalar group's :meth:`run_sum` (on K1 the
    summed kernel's partials), else ``run`` / ``run_batch``."""
    if unit.scalar:
        return lambda: ex.run_sum(a, batched)
    return (lambda: ex.run_batch(a)) if batched else (lambda: ex(a))


def spec_executors(units, env, g, batched: bool = False) -> list:
    """``(unit, adjoint env, executor)`` of each adjoint program of
    ``units`` (default backend), as the backward fetches them from the
    executor cache; ``batched``: ``env`` and ``g`` are stacked."""
    from repro_torch import compile_plan
    from repro_torch.core.adjoint import assemble_adjoint_env
    from repro_torch.core.executor import stacked_signature

    out = []
    for unit in units:
        a = assemble_adjoint_env(unit, env, g)
        plan = unit.result().plan
        out.append((unit, a, compile_plan(
            plan, stacked_signature(a), device=DEVICE) if batched
            else compile_plan(plan, a)))
    return out


def adjoint_executors(program, env, g, batched: bool = False) -> list:
    """``(unit, adjoint env, executor)`` for each adjoint program a
    first-order backward of every input runs (``adjoint_runs``: each array
    spec, then the scalars' group where it is admitted, else each scalar
    spec)."""
    from repro_torch.core.adjoint import adjoint_build, adjoint_runs

    return spec_executors(adjoint_runs(adjoint_build(program), env, g,
                                       list(env)), env, g, batched)


@contextlib.contextmanager
def captured_sums(adj):
    """Records what each executor of ``adj`` returns from ``run_sum`` in
    the block: ``{id(executor): [outputs, ...]}``."""
    seen = {}
    for _, _, ex in adj:
        def record(env, batched=False, _run=ex.run_sum, _key=id(ex)):
            out = _run(env, batched)
            seen.setdefault(_key, []).append(out)
            return out

        ex.run_sum = record
    try:
        yield seen
    finally:
        for _, _, ex in adj:
            ex.__dict__.pop("run_sum", None)


def group_gate(adj, seen, env, grads: dict) -> list:
    """The gate on each scalar group of ``adj``: its executor's
    ``run_sum`` ran once in the backward (``seen``, from
    :func:`captured_sums`), and each member's gradient in ``grads`` is,
    bit for bit, what that run's partials give it.  Returns the failures."""
    import torch

    from repro_torch.core.adjoint import ScalarGroup, finalize_adjoint

    bad = []
    for unit, _, ex in adj:
        if not isinstance(unit, ScalarGroup):
            continue
        runs = seen.get(id(ex), [])
        if len(runs) != 1:
            bad.append(f"group {unit_label(unit)} ran {len(runs)} times")
            continue
        for m in unit.members:
            want = finalize_adjoint(m, env, runs[0][m.gu])
            if not torch.equal(grads[m.input].reshape(want.shape), want):
                bad.append(f"{m.input}'s gradient is not its group's")
    return bad


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
        with captured_sums(adj) as seen:
            grads = torch.autograd.grad([out[k] for k in g],
                                        [p[k] for k in keys],
                                        [g[k] for k in g], allow_unused=True)
        torch.cuda.synchronize()
        launches = [ex.kernel_launches - b for (_, _, ex), b in zip(
            adj, before)]
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
        for (unit, _, ex), launched in zip(adj, launches):
            codes = ",".join(r.code for r in ex.selection.capability.reasons)
            specs.append(f"{unit_label(unit)}:{ex.backend}"
                         f"[{codes or 'eligible'}] launches {launched}")
            ok &= ex.backend == "hopper" and launched == 1
            on_kernel += ex.backend == "hopper"
        # every spec in exactly one run; each group's scalars from its launch
        covered = sorted(s.input for u, _, _ in adj for s in u.members)
        ok &= covered == sorted(s.input for s in build.specs)
        bad = group_gate(adj, seen, env, dict(zip(keys, grads)))
        ok &= not bad
        adjoint = ("adjoint " + "; ".join(specs + bad) if build.ok
                   else f"autodiff fallback: {build.reason}")
        line = (f"grad {case.name} r{case.reassociate} float32: grads vs "
                f"float64 baseline {err:.2e} (<= {tol:.0e}); {adjoint} "
                f"{'ok' if ok else 'FAIL'}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    print(f"grad sweep: {on_kernel} adjoint runs on the kernel", flush=True)
    return failures


def fault_runs(cells) -> list:
    """``(name, level, program, RaceResult, last field)`` of each fault
    cell, its program (``repro_torch.testing.faults``) at three times its
    test extent."""
    from repro_torch import race
    from repro_torch.core import ir
    from repro_torch.testing.faults import N, PROGRAMS

    out = []
    for name, lvl, last in cells:
        program = PROGRAMS[name](ir, SWEEP_SCALE * N)
        out.append((name, lvl, program, race(program, reassociate=lvl),
                    last))
    return out


def fault_env(program, torch) -> dict:
    """A float32 env on the card of the inputs the program reads (the
    output arrays left out), from seed 1."""
    import types

    import numpy as np

    from repro_torch.core.ir import expr_refs
    from repro_torch.testing import build_env, env_to_torch

    read = {r.name for st in program.body for r in expr_refs(st.rhs)}
    env = build_env(types.SimpleNamespace(program=program, scalars=()),
                    np.float32, seed=1)
    return env_to_torch({k: v for k, v in env.items() if k in read}, DEVICE)


def fault_sources(mesh) -> list:
    """The K1 sources of the fault cells, built in phase 2: each forward
    plan and each adjoint spec's plan that ``"auto"`` sends to the kernel
    at float32, single-device (phase 5) and, for phase 14's cells, each
    shard's local plan."""
    import numpy as np

    from repro_torch import env_signature
    from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
    from repro_torch.core.backend import select_backend
    from repro_torch.core.codegen import required_shapes
    from repro_torch.core.executor import ExecutorCache
    from repro_torch.core.ir import expr_refs
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.shard import ShardingUnavailable, compile_sharded
    from repro_torch.testing.faults import FORCED

    def shapes_of(program):  # the inputs it reads, as fault_env
        read = {r.name for st in program.body for r in expr_refs(st.rhs)}
        return {k: v for k, v in required_shapes(program).items()
                if k in read}

    out = []
    for name, _, program, res, _ in fault_runs(FAULT_CELLS):
        shapes = shapes_of(program)
        units = [(res.plan, shapes, False)] + [
            (spec.result().plan,
             adjoint_env_shapes(spec, program, shapes), spec.scalar)
            for spec in adjoint_build(program).specs if name not in FORCED]
        for plan, shp, summed in units:
            if select_backend(plan, "auto", ["float32"]).backend == "hopper":
                sp = specialize_stencil(plan, shp, {k: "float32" for k in shp})
                out.append(sp.source_for(1, summed))
    cache = ExecutorCache()
    for _, _, program, res, _ in fault_runs(SHARD_FAULT_CELLS):
        shapes = shapes_of(program)
        units = [(res, shapes)] + [
            (spec.result(), adjoint_env_shapes(spec, program, shapes))
            for spec in adjoint_build(program).specs]
        for r, shp in units:
            sig = env_signature({k: np.zeros(v, np.float32)
                                 for k, v in shp.items()})
            try:
                sr = compile_sharded(r, sig, mesh, cache=cache)
            except ShardingUnavailable:
                continue
            out += [ex.spec.source for ex in sr.locals.values()
                    if ex.spec is not None]
    return out


def k1_launch_counts() -> dict:
    """``{id(executor): (executor, K1 launches)}`` of every single-device
    executor in the process-wide cache (a sharded executor's locals are
    among them)."""
    from repro_torch.core.executor import executor_cache
    from repro_torch.shard import ShardedRace

    return {id(ex): (ex, ex.kernel_launches)
            for ex in executor_cache().executors()
            if not isinstance(ex, ShardedRace)}


def k1_launched_since(before: dict) -> int:
    """K1 launches since ``before`` (:func:`k1_launch_counts`) of the
    executors in the cache now: one the LRU cache evicted since adds
    nothing, one it added since counts from 0."""
    return sum(n - before.get(i, (None, 0))[1]
               for i, (_, n) in k1_launch_counts().items())


@contextlib.contextmanager
def forced_autodiff(on: bool):
    """``RACE_ADJOINT=autodiff`` in the block where ``on``."""
    old = os.environ.get("RACE_ADJOINT")
    if on:
        os.environ["RACE_ADJOINT"] = "autodiff"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RACE_ADJOINT", None)
        else:
            os.environ["RACE_ADJOINT"] = old


def fault_baseline(program, res, env, keys, torch) -> tuple:
    """The cotangents (:func:`cos_weights`, float64) and autograd of the
    float64 baseline program: ``(g, {input: gradient})``, zeros where
    autograd gives none."""
    from repro_torch.core.codegen import interior

    env64 = {k: v.double().requires_grad_() if k in keys else v.double()
             for k, v in env.items()}
    base = interior(res.plan, res.baseline_evaluator()(env64))
    g = cos_weights(base, torch)
    live = [k for k in g if base[k].requires_grad]  # not a constant output
    want = torch.autograd.grad([base[k] for k in live],
                               [env64[k] for k in keys],
                               [g[k] for k in live], allow_unused=True)
    return g, {k: torch.zeros_like(env64[k]) if v is None else v
               for k, v in zip(keys, want)}


def fault_check(name, grads, want, env, tol, torch) -> tuple:
    """One fault backward's gradients: ``(ok, text)``.  Every wanted
    gradient within ``tol`` of the float64 baseline's, and the cancelled
    input's exact zeros of its dtype, shape and device."""
    from repro_torch.testing import rel_err
    from repro_torch.testing.faults import CANCELLED

    err = rel_err(grads, {k: want[k] for k in grads})
    ok = err <= tol
    text = f"{'+'.join(grads)} {err:.2e}"
    c = CANCELLED.get(name)
    if c in grads:
        z = grads[c]
        zero = (z.dtype == env[c].dtype and z.shape == env[c].shape
                and z.device == env[c].device
                and torch.equal(z, torch.zeros_like(z)))
        ok &= zero
        text += f" {c} zeros {zero}"
    return ok, text


def fault_grads(torch) -> list:
    """Phase 5's fault programs (ROADMAP F14, F15) on the card at float32:
    ``torch.autograd.grad`` through ``res.run`` on each backend of the
    cell, for each read input alone and all of them, without
    ``allow_unused`` (a ``None`` gradient raises), against autograd of the
    float64 baseline (:func:`fault_check`); the backward's K1 launches
    are those of the wanted adjoint specs ``"auto"`` admits, one each
    (none on the autograd fallback, whose torch ops run on the card).
    Returns the failures."""
    import numpy as np

    from repro_torch.core.adjoint import adjoint_build
    from repro_torch.core.backend import select_backend
    from repro_torch.testing import default_tolerances
    from repro_torch.testing.faults import FORCED

    tol = default_tolerances(np.float32)["grad"]
    failures = []
    for name, lvl, program, res, backends in fault_runs(FAULT_CELLS):
        env = fault_env(program, torch)
        keys = sorted(k for k, v in env.items() if v.is_floating_point())
        g, want = fault_baseline(program, res, env, keys, torch)
        g = {k: v.float() for k, v in g.items()}
        build = adjoint_build(program)
        admitted = {s.input for s in build.specs
                    if name not in FORCED and select_backend(
                        s.result().plan, "auto", ["float32"]).backend
                    == "hopper"}
        for backend in backends:
            parts, ok = [], True
            for wrt in [[k] for k in keys] + [keys]:
                p = {k: env[k].clone().requires_grad_() for k in wrt}
                with forced_autodiff(name in FORCED):
                    out = res.run({**env, **p}, backend, device=DEVICE)
                    before = k1_launch_counts()
                    grads = torch.autograd.grad(
                        [out[k] for k in g], [p[k] for k in wrt],
                        [g[k] for k in g])
                    torch.cuda.synchronize()
                    launched = k1_launched_since(before)
                expected = len(admitted & set(wrt))
                good, text = fault_check(name, dict(zip(wrt, grads)), want,
                                         env, tol, torch)
                ok &= good and launched == expected
                parts.append(f"{text} K1 {launched}/{expected}")
            how = (f"autodiff fallback: {build.reason}" if not build.ok
                   else "forced autodiff" if name in FORCED else "stencil")
            line = (f"grad-fault {name} r{lvl} {backend} float32 ({how}): "
                    f"wrt, vs float64 baseline (<= {tol:.0e}), K1 launches/"
                    f"admitted specs: {'; '.join(parts)} "
                    f"{'ok' if ok else 'FAIL'}")
            print(line, flush=True)
            if not ok:
                failures.append(line)
    return failures


def scalar_library_call(case, env, g, absolute: bool = False):
    """j3d27pt's scalar gradients by one library call, as a thunk, or None
    for the other cells: ``torch.nn.grad.conv3d_weight`` of ``u`` and the
    cotangent gives the gradient ``dW`` of the 27 weights of
    :func:`library_call`'s ``F.conv3d`` (TF32 off: ``main`` clears it),
    then the fold of those 27 numbers into the 5 scalars: a tap's weight is
    ``jc<c> / jnorm`` (``c`` its nonzero offsets), so ``d jc<c>`` sums
    ``dW / jnorm`` over the taps of ``c`` and ``d jnorm`` is ``-sum dW w /
    jnorm``.  ``absolute``: the same of ``|u|``, ``|g|`` and ``|w|``, each
    scalar's sum of the absolute values of its terms (the scale its
    float32 sums are rounded against)."""
    if case.name != "j3d27pt":
        return None
    import torch

    u, gy = env["u"][None, None], g["j27"][None, None]
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)))
    count = (offs != 0).sum(1).reshape(3, 3, 3).to(u.device)
    masks = [count == c for c in range(4)]
    jc = torch.stack([env[f"jc{c}"] for c in range(4)]).double()
    jn = env["jnorm"].double()
    w = jc[count] / jn
    if absolute:  # in float32: float16 sums of 1.3e8 terms overflow
        u, gy = u.abs().float(), gy.abs().float()
        jn, w = jn.abs(), w.abs()

    def run():
        # cuDNN's benchmark search over its first two algorithms: at 512^3
        # float32 the heuristic's own pick ran ~35x slower, and a full
        # search cost more than the rest of phase 6 (PERF.md §6)
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                        benchmark_limit=2,
                                        deterministic=False,
                                        allow_tf32=False):
            dw = torch.nn.grad.conv3d_weight(u, (1, 1, 3, 3, 3), gy)
        dw = dw[0, 0].double()
        out = {f"jc{c}": dw[m].sum() / jn for c, m in enumerate(masks)}
        out["jnorm"] = -(dw * w).sum() / jn
        return {k: v.abs() for k, v in out.items()} if absolute else out

    return run


def grad_full_size(case, dt, res, torch) -> tuple:
    """Phase 6 for one cell; returns its kernel lines (the adjoint plans'
    kernels, and the scalars' group's alone where there is one) and the
    backward's ms, and prints the backward's time and launches."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.adjoint import ScalarGroup, adjoint_build, backward
    from repro_torch.testing import default_tolerances, rel_err, torch_env
    from repro_torch.testing.differential import dtype_name

    dname = dtype_name(dt)
    outs = {st.lhs.name for st in case.program.body}
    env = {k: v for k, v in torch_env(case, dt, 0, DEVICE).items()
           if k not in outs}
    keys = sorted(k for k, v in env.items() if v.is_floating_point())
    p = {k: env[k].clone().requires_grad_() for k in keys}
    out = res.run({**env, **p}, device=DEVICE)
    g = cos_weights(out, torch)
    adj = adjoint_executors(case.program, env, g)
    kern = [(unit, a, ex) for unit, a, ex in adj if ex.backend == "hopper"]
    for _, _, ex in kern:
        ex.spec.launches = 0

    def bwd():
        return torch.autograd.grad([out[k] for k in g],
                                   [p[k] for k in keys],
                                   [g[k] for k in g], retain_graph=True,
                                   allow_unused=True)

    with captured_sums(adj) as seen:
        grads = bwd()
    torch.cuda.synchronize()
    per_run = [ex.kernel_launches for _, _, ex in kern]
    launches = sum(per_run)
    if not kern or len(kern) != len(adj) or per_run != [1] * len(kern):
        raise SystemExit(f"{case.name}: the backward launched {per_run} "
                         f"kernels for {len(adj)} adjoint runs, want 1 each "
                         f"on K1")
    bad = group_gate(adj, seen, env, dict(zip(keys, grads)))
    if bad:
        raise SystemExit(f"{case.name}: {'; '.join(bad)}")
    plain = backward(case.program, env, g, backend="torch")
    e_plan = rel_err({k: v for k, v in zip(keys, grads) if v is not None},
                     {k: plain[k] for k, v in zip(keys, grads)
                      if v is not None})
    max_abs = max(float((v.double() - plain[k].double()).abs().max())
                  for k, v in zip(keys, grads) if v is not None)
    # float16: K1 computes in float32, the "torch" plans op by op in
    # float16: held to the dtype's grad row, not to plan
    tol = default_tolerances(dt)["grad" if dname in HALF_DTYPES else "plan"]
    if e_plan > tol:
        raise SystemExit(f"{case.name}: backward vs torch adjoint plans "
                         f"{e_plan:.2e} > {tol:.0e}")
    group = next(((u, a, ex) for u, a, ex in kern
                  if isinstance(u, ScalarGroup)), None)
    group_abs = None if group is None else max(
        float((v.double() - plain[k].double()).abs().max())
        for k, v in zip(keys, grads) if k in unit_label(group[0]).split("+"))
    grads = dict(zip(keys, grads))
    del plain
    backward_ms = _time_ms(bwd, torch)
    plain_backward_ms = _time_ms(
        lambda: backward(case.program, env, g, backend="torch"), torch)
    kernel_ms = torch_ms = 0.0
    nbytes = ops = 0
    itemsize = ITEMSIZE[dname]
    per_spec, unit_work = [], {}
    for unit, a, ex in kern:
        ms = _time_ms(adjoint_call(unit, ex, a), torch)
        kernel_ms += ms
        per_spec.append(f"{unit_label(unit)} {ms:.4f}")
        ex_t = compile_plan(unit.result().plan, a, "torch")
        t_ms = _time_ms(lambda: ex_t(a), torch)
        torch_ms += t_ms
        b, o = plan_work(unit.result().plan, a, itemsize, unit.scalar)
        nbytes, ops = nbytes + b, ops + o
        unit_work[id(unit)] = (ms, t_ms, b, o)
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    # the byte bound of the per-spec way: every spec its own launch
    old_bytes = sum(unit_work[id(u)][2] for u, _, _ in kern
                    if not isinstance(u, ScalarGroup))
    on_torch = [f"{unit_label(u)}[{','.join(r.code for r in ex.selection.capability.reasons)}]"
                for u, _, ex in adj if ex.backend != "hopper"]
    label = case.name if dname not in HALF_DTYPES else f"{case.name} {dname}"
    print(f"grad-main {case.name} {dname}: adjoint specs "
          f"{len(adjoint_build(case.program).specs)} in {len(adj)} runs "
          f"({', '.join(unit_label(u) for u, _, _ in adj)}), on the kernel "
          f"{len(kern)}, on torch {on_torch or 'none'}; backward launches "
          f"{launches}, backward_ms {backward_ms:.4f} (torch adjoint plans "
          f"{plain_backward_ms:.4f}); adjoint kernels kernel_ms "
          f"{kernel_ms:.4f}, torch_ms {torch_ms:.4f}, bytes {nbytes}, "
          f"bound_ms {bound_ms:.4f} ({by}), share of bound "
          f"{bound_ms / kernel_ms:.3f}; grads vs torch {e_plan:.2e} (<= "
          f"{tol:.0e}), max_abs_err {max_abs:.3e}; per run ms: "
          f"{', '.join(per_spec)}", flush=True)
    common = dict(route="cuda", source="src/repro_torch/lowering/emit.py",
                  replaces="src/repro/lowering/emit.py:273")
    entries = [dict(name=f"race_stencil[{label} adjoint]", launches=launches,
                    max_abs_err=max_abs, ms=kernel_ms, plain_ms=torch_ms,
                    bound_ms=bound_ms, bound_by=by, library_ms=None,
                    **common)]
    if group is None:
        old_ms = bound_of(old_bytes, 0, PEAK_FLOPS[dname])[0]
        print(f"grad-main {case.name} {dname}: no scalar group; byte bound "
              f"{old_ms:.4f} ms", flush=True)
        return entries, backward_ms
    unit, a, ex = group
    members = spec_executors(unit.members, env, g)
    off = [s.input for s, _, e in members if e.backend != "hopper"]
    if off:
        raise SystemExit(f"{case.name}: members {off} of the group are off "
                         f"K1 alone")
    old_bytes += sum(plan_work(s.result().plan, sa, itemsize, True)[0]
                     for s, sa, _ in members)
    # the group and its members' own summed launches, in turns
    turns = []
    for _ in range(2):
        g_ms = _time_ms(adjoint_call(unit, ex, a), torch)
        m_ms = [_time_ms(adjoint_call(s, e, sa), torch)
                for s, sa, e in members]
        turns.append((g_ms, m_ms))
    ms, t_ms, b, o = unit_work[id(unit)]
    g_bound, g_by = bound_of(b, o, PEAK_FLOPS[dname])
    old_ms = bound_of(old_bytes, 0, PEAK_FLOPS[dname])[0]
    new_ms = bound_of(nbytes, 0, PEAK_FLOPS[dname])[0]
    tp = ex.spec.program(1)
    geo = tp.geometry
    lib, lib_ms, lib_txt = scalar_library_call(case, env, g), None, "none"
    if lib is not None:
        # each scalar sums ~1.3e8 terms of both signs: as for the taps
        # (tap_adjoint_check), the float32 sums are held to plan of the
        # sum of their terms' absolute values, the error relative to the
        # scalar itself printed beside it
        got = lib()
        scale = scalar_library_call(case, env, g, absolute=True)()
        torch.cuda.synchronize()
        e_lib = max(abs(float(grads[k].double() - v)) / float(scale[k])
                    for k, v in got.items())
        e_rel = rel_err({k: grads[k] for k in got}, got)
        lib_tol = default_tolerances(dt)["plan"]
        if e_lib > lib_tol:
            raise SystemExit(f"{case.name}: conv3d_weight and the group "
                             f"disagree on the scalars ({e_lib:.2e} of the "
                             f"absolute sums, {e_rel:.2e} of the scalars)")
        lib_ms = _time_ms(lib, torch)
        lib_txt = (f"conv3d_weight and the fold {lib_ms:.4f} ms, vs the "
                   f"group {e_lib:.2e} of the absolute sums (<= "
                   f"{lib_tol:.0e}), {e_rel:.2e} of the scalars")
    print(f"grad-main {case.name} {dname} scalars {unit_label(unit)} on "
          f"{_nvidia_smi()}: group (1 launch) {ms:.4f} ms, torch "
          f"{t_ms:.4f}, bound {g_bound:.4f} ({g_by}), share of bound "
          f"{g_bound / ms:.3f}; in turns group / members' {len(members)} "
          f"launches ms "
          f"{[(round(x, 4), round(sum(y), 4)) for x, y in turns]}, "
          f"members each {[[round(v, 4) for v in y] for _, y in turns]}; "
          f"backward byte bound {old_ms:.4f} ms per spec -> {new_ms:.4f} ms "
          f"with the group; library {lib_txt}; group schedule "
          f"{geometry_text(geo)}, smem {tp.smem_bytes} B, "
          f"aux_evals_per_point {tp.aux_evals_per_point:.3f}, aux "
          f"{[x.name for x in unit.result().plan.aux_order]}, resources "
          f"{k1_resources(ex.spec.source_for(1, True))}, step "
          f"{k1_step(tp, ex.spec.source_for(1, True))}", flush=True)
    entries.append(dict(name=f"race_stencil[{label} adjoint scalars]",
                        launches=1, max_abs_err=group_abs, ms=ms,
                        plain_ms=t_ms, bound_ms=g_bound, bound_by=g_by,
                        library_ms=lib_ms, **common))
    del members
    return entries, backward_ms


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


def k1_resources(source: str) -> str:
    """The resource line (``cuobjdump --dump-resource-usage``: registers,
    stack, shared, local) of the stencil kernel in the built library of a
    K1 source."""
    from repro_torch.kernels import build

    so = build.library_path(source)
    tool = str(Path(build._nvcc()).parent / "cuobjdump")
    usage = subprocess.run([tool, "--dump-resource-usage", str(so)],
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.splitlines()
    return next((ln.strip() for prev, ln in zip(usage, usage[1:])
                 if "race_stencil_kernel" in prev), "not found")


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
    geometry_turns(f"batch {label} B={B}", res.plan, sig, B,
                   lambda e: e.run_batch(stacked), got, tol, torch)
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
    the adjoint kernels launch once per run (each array spec, the scalars'
    group), each example's gradient is held against ``run``'s; returns the
    adjoint kernels' line."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.executor import stack_envs, stacked_signature
    from repro_torch.testing import default_tolerances, rel_err

    dname = np.dtype(dt).name
    stacked = stack_envs(batch_envs(case, dt, B), DEVICE)
    keys = sorted(k for k, v in stacked.items() if v.is_floating_point())
    p = {k: stacked[k].clone().requires_grad_() for k in keys}
    out = res.run_batch({**stacked, **p}, device=DEVICE)
    g = cos_weights(out, torch)
    adj = adjoint_executors(case.program, stacked, g, batched=True)
    if not all(ex.backend == "hopper" for _, _, ex in adj):
        raise SystemExit(f"{label}: an adjoint run is not on the kernel")
    for _, _, ex in adj:
        ex.spec.launches = 0

    def bwd():
        return torch.autograd.grad([out[k] for k in g], [p[k] for k in keys],
                                   [g[k] for k in g], retain_graph=True)

    with captured_sums(adj) as seen:
        grads = dict(zip(keys, bwd()))
    torch.cuda.synchronize()
    launched = [ex.kernel_launches for _, _, ex in adj]
    bad = group_gate(adj, seen, stacked, grads)
    if launched != [1] * len(adj) or bad:
        raise SystemExit(f"{label}: batched backward launches per run "
                         f"{launched}, want 1 each; {bad}")
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
    for unit, a, ex in adj:
        kernel_ms += _time_ms(adjoint_call(unit, ex, a, True), torch)
        ex_t = compile_plan(unit.result().plan, stacked_signature(a),
                            "torch", device=DEVICE)
        torch_ms += _time_ms(lambda: ex_t.run_batch(a), torch)
        k_out = adjoint_call(unit, ex, a, True)()
        t_out = ex_t.run_batch(a)
        if unit.scalar:  # each example's sum: of the partials, the box
            k_out, t_out = ({k: v.double().flatten(1).sum(1)
                             for k, v in o.items()} for o in (k_out, t_out))
        max_abs = max(max_abs, max(float((k_out[k].double()
                                          - t_out[k].double()).abs().max())
                                   for k in t_out))
        b_, o_ = plan_work(unit.result().plan,
                           {k: v[0] for k, v in a.items()}, itemsize,
                           unit.scalar)
        nbytes, ops = nbytes + b_ * B, ops + o_ * B
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    print(f"batch-grad {label} {dname} B={B}: adjoint runs "
          f"{[unit_label(u) for u, _, _ in adj]}, all on the kernel, "
          f"launches per run {launched}; backward_ms "
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


def constant_cells() -> list:
    """Phase 3's programs with constant subexpressions: (label, RaceResult,
    float64 numpy env) for ``repro_torch.apps.constant_kernels``' programs
    and its ``@race_kernel`` twin (``math.sqrt(2.0)`` and ``math.exp(0.1)``
    coefficients), at reassociate 3 over CONST_N points."""
    import numpy as np

    from repro_torch import race, race_kernel
    from repro_torch.apps import constant_kernels

    u = np.random.default_rng(7).uniform(-1, 1, CONST_N + 2)
    out = [(name, race(prog, reassociate=3), {"u": u})
           for name, prog in constant_kernels.programs(n=CONST_N).items()]
    env = {"u": u, "o": np.zeros(CONST_N + 2)}
    twin = race_kernel(constant_kernels.twin, reassociate=3).trace(
        {k: v.shape for k, v in env.items()})
    return out + [("twin", twin, env)]


def constant_sources() -> list:
    """The K1 sources (float64) of the constant cells the kernel takes."""
    from repro_torch.core.backend import select_backend
    from repro_torch.lowering.emit import specialize_stencil

    return [specialize_stencil(res.plan, {k: v.shape for k, v in env.items()},
                               {k: "float64" for k in env}).source
            for _, res, env in constant_cells()
            if select_backend(res.plan, "auto", ["float64"]).backend
            == "hopper"]


def constant_check(torch) -> list:
    """Phase 3's constant cells on the card: where K1 takes the program,
    K1 against ``"torch"`` at float64 within ``plan`` (its launch count
    rising); ``o[i] = 0.1`` (K1 refuses it: no array to stream) on
    ``"torch"`` only, its output float64 and 0.1 everywhere; ``log(-1.0)``
    nan on both.  Returns the failing lines."""
    from repro_torch import compile_plan
    from repro_torch.core.backend import select_backend
    from repro_torch.testing import default_tolerances, env_to_torch, rel_err

    tol = default_tolerances("float64")["plan"]
    failures = []
    for label, res, env_np in constant_cells():
        env = env_to_torch(env_np, DEVICE)
        plain = res.run(env, "torch", device=DEVICE)
        sel = select_backend(res.plan, "auto", ["float64"])
        if sel.backend != "hopper":
            (o,) = plain.values()
            ok = (label == "const" and o.dtype == torch.float64
                  and bool((o == 0.1).all()))
            why = sel.capability.explain()
            line = (f"constants {label}: K1 refuses ({why}); torch "
                    f"output {o.dtype}, all 0.1 {bool((o == 0.1).all())} "
                    f"{'ok' if ok else 'FAIL'}")
        else:
            ex = compile_plan(res.plan, env, "hopper")
            before = ex.kernel_launches
            got = res.run(env, "hopper", device=DEVICE)
            torch.cuda.synchronize()
            launched = ex.kernel_launches - before
            if label == "log_neg":
                e = "nan on both" if all(
                    bool(torch.isnan(v).all()) for v in
                    (*got.values(), *plain.values())) else "not nan"
                ok = launched == 1 and e == "nan on both"
            else:
                e = rel_err(got, plain)
                ok = launched == 1 and e <= tol
                e = f"{e:.2e} (<= {tol:.0e})"
            line = (f"constants {label} float64: launches {launched} "
                    f"hopper-vs-torch {e} {'ok' if ok else 'FAIL'}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    return failures


def full_size_cells():
    """The four cells of phases 4 and 6: (case, dtype)."""
    import numpy as np

    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm

    return [(get_case("j3d27pt", 512), np.float32),
            (get_case("poisson", 512), np.float32),
            (get_case("derivative", 256), np.float64),
            (pop_hdifft_gm(8192, 8192), np.float32)]


def half_cells():
    """Phase 4's half cells (j3d27pt float16 first: phase 6 differentiates
    it): (case, dtype name)."""
    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import pop_hdifft_gm

    cases = [pop_hdifft_gm(n, n) if name == "hdifft_gm" else get_case(name, n)
             for name, n in HALF_CELLS]
    return [(case, dt) for case in cases for dt in HALF_DTYPES]


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


def mixer_sweep(torch) -> None:
    """``--mixer-sweep``: K1 on the mixer at ``sx`` 516 x C for C in
    MIXER_CONV_CHANNELS and the full width (the forward, the ``sx``
    adjoint and ``sw0``'s summed adjoint) at every (segment, plane width)
    of MIXER_SWEEP_SEGMENTS x MIXER_SWEEP_WIDTHS and at the chooser's own
    geometry: each checked against ``"torch"`` (``sw0``: its sum, within
    ``plan`` of ``sum |g b|``), then timed one call at a time
    (:func:`_time_ms`) and queued (:func:`_queued_ms`), beside
    ``F.conv1d`` / ``torch.mv`` queued the same way."""
    from repro_torch import compile_plan
    from repro_torch.configs import get_config
    from repro_torch.core.adjoint import adjoint_build, assemble_adjoint_env
    from repro_torch.kernels.build import compile_sources
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.models.ssm import _smooth_result, smooth_env
    from repro_torch.testing import default_tolerances, rel_err

    g = torch.Generator(DEVICE).manual_seed(5)
    taps = 0.5 * torch.randn(LM_RADIUS + 1, generator=g, device=DEVICE)
    full = _train_arg("--batch") * get_config(LM_ARCH).d_model
    configs = [(0, 0)] + [(seg, w) for seg in MIXER_SWEEP_SEGMENTS
                          for w in MIXER_SWEEP_WIDTHS]
    cells = []  # (C, kind, plan, env, [(config, spec)], library thunk)
    for C in MIXER_CONV_CHANNELS + (full,):
        res = _smooth_result(LM_PROMPT, C, LM_RADIUS)
        x = torch.randn((2, LM_PROMPT, C // 2), generator=g, device=DEVICE,
                        dtype=torch.bfloat16)
        env = smooth_env(x, taps, LM_RADIUS)
        gy = {"sy": torch.randn(env["sy"].shape, generator=g,
                                device=DEVICE)}
        specs = {s.input: s for s in adjoint_build(res.program).specs}
        runs = [("forward", res.plan, env,
                 mixer_library_call(env, LM_RADIUS, torch))]
        for name in ("sx", "sw0"):
            a = assemble_adjoint_env(specs[name], env, gy)
            lib = (sx_adjoint_library_call(a, LM_RADIUS, torch)
                   if name == "sx" else
                   tap_adjoint_library_call(a, LM_RADIUS, torch, "mv"))
            runs.append((name, specs[name].result().plan, a, lib))
        for kind, plan, e, lib in runs:
            shapes = {k: tuple(v.shape) for k, v in e.items()}
            dtypes = {k: "float32" for k in e}
            cells.append((C, kind, plan, e, [
                (cfg, specialize_stencil(plan, shapes, dtypes, cfg[0], 0,
                                         cfg[1])) for cfg in configs], lib))
    t0 = time.time()
    compile_sources([sp.source_for(1, kind == "sw0")
                     for _, kind, _, _, specs, _ in cells
                     for _, sp in specs])
    print(f"mixer-sweep build: {sum(len(c[4]) for c in cells)} sources in "
          f"{time.time() - t0:.1f} s", flush=True)
    tol = default_tolerances("float32")["plan"]
    failures = 0
    for C, kind, plan, e, specs, lib in cells:
        want = compile_plan(plan, e, "torch")(e)
        lib_ms = _time_ms(lib, torch)
        lib_q, ahead = _queued_ms(lib, torch)
        print(f"mixer-sweep C={C} {kind}: library "
              f"{'mv' if kind == 'sw0' else 'conv1d'} {lib_ms:.4f} ms a "
              f"call, queued {lib_q:.4f} (ahead {ahead})", flush=True)
        for cfg, sp in specs:
            if kind == "sw0":
                (gu,) = want
                fn = (lambda sp=sp, e=e: sp.apply_sum(e))
                got = float(fn()[gu].double().sum())
                scale = float(want[gu].double().abs().sum())
                err = abs(got - float(want[gu].double().sum())) / scale
            else:
                fn = (lambda sp=sp, e=e: sp(e))
                err = rel_err(fn(), want)
            torch.cuda.synchronize()
            ms = _time_ms(fn, torch)
            q, ahead = _queued_ms(fn, torch)
            geo = sp.tp.geometry
            ok = err <= tol
            failures += not ok
            name = "chooser" if cfg == (0, 0) else cfg
            print(f"mixer-sweep C={C} {kind} {name}: segment {geo.seg}, "
                  f"plane {geo.plane_points}, blocks "
                  f"{geo.n_tiles}, threads {geo.threads}, k0 {geo.k0}, "
                  f"{ms:.4f} ms a call, queued {q:.4f} (ahead {ahead}), "
                  f"err {err:.2e} {'ok' if ok else 'FAIL'}", flush=True)
        del want
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"mixer sweep: {failures} runs disagree with torch")


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


def twin_cells():
    """The cells of phase 11, one per plain-Python twin
    (``repro_torch.apps.frontend_kernels.TWINS``): (case, dtype) at the
    sizes of K1's full-size cells."""
    import numpy as np

    from repro_torch.apps import get_case
    from repro_torch.apps.paper_kernels import (pop_calc_tpoints,
                                                pop_hdifft_gm)

    return [(pop_calc_tpoints(8192, 8192), np.float32),
            (pop_hdifft_gm(8192, 8192), np.float32),
            (get_case("psinv", 512), np.float32),
            (get_case("resid", 512), np.float32),
            (get_case("j3d27pt", 512), np.float32),
            (get_case("poisson", 512), np.float32)]


def twin_main(case, dt, res, phase4_ms, torch) -> dict:
    """Phase 11 for one twin: ``race_kernel(twin).run(env)`` on ``"auto"``
    against the DSL case's ``res`` on the card; returns its kernel line."""
    import numpy as np

    from repro_torch import compile_plan, plan_hash, program_hash
    from repro_torch import race_kernel
    from repro_torch.apps.frontend_kernels import TWINS
    from repro_torch.core.codegen import interior
    from repro_torch.kernels.build import library_path
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.testing import (build_env, default_tolerances,
                                     env_to_torch, rel_err)

    name, dname = case.name, np.dtype(dt).name
    tol = default_tolerances(dt)
    kern = race_kernel(TWINS[name], reassociate=case.reassociate)
    env = env_to_torch(build_env(case, dt, seed=0), DEVICE)
    shapes = {k: tuple(v.shape) for k, v in env.items()}
    t_res = kern.trace(shapes)  # capture, detection, contraction
    if program_hash(t_res.program) != program_hash(case.program):
        raise SystemExit(f"twin {name}: captured program differs from the "
                         f"DSL case's")
    ex = compile_plan(t_res.plan, env)
    if ex.backend != "hopper":
        raise SystemExit(f"twin {name}: auto selected {ex.backend}: "
                         f"{ex.selection.capability.explain()}")
    ex.spec.launches = 0
    got = kern.run(env, device=DEVICE)
    torch.cuda.synchronize()
    launches = ex.kernel_launches
    if launches != 1:
        raise SystemExit(f"twin {name}: race_kernel.run launched {launches} "
                         f"kernels, want 1")
    ph = plan_hash(t_res.plan)
    digest = library_path(ex.spec.source).stem
    dsl_digest = library_path(specialize_stencil(
        res.plan, shapes, {k: dname for k in shapes}).source).stem
    if ph != plan_hash(res.plan) or digest != dsl_digest:
        raise SystemExit(f"twin {name}: plan {ph} / source {digest} differ "
                         f"from the DSL case's {plan_hash(res.plan)} / "
                         f"{dsl_digest}")
    want = res.run(env, device=DEVICE)
    torch.cuda.synchronize()
    if not all(torch.equal(got[k], want[k]) for k in want):
        raise SystemExit(f"twin {name}: output differs from the DSL case's")
    del want
    env64 = {k: v.double() for k, v in env.items()}
    truth = interior(res.plan, res.baseline_evaluator()(env64))
    del env64
    e_base = rel_err(got, truth)
    del truth
    if e_base > tol["baseline"]:
        raise SystemExit(f"twin {name}: vs float64 baseline {e_base:.2e} > "
                         f"{tol['baseline']:.0e}")
    ex_t = compile_plan(res.plan, env, "torch")
    plain = ex_t(env)
    torch.cuda.synchronize()
    e_plan = rel_err(got, plain)
    max_abs = max(float((got[k].double() - plain[k].double()).abs().max())
                  for k in plain)
    del plain
    if e_plan > tol["plan"]:
        raise SystemExit(f"twin {name}: hopper vs torch {e_plan:.2e} > "
                         f"{tol['plan']:.0e}")
    lib = library_call(case, env)
    if lib is not None:
        e_lib = rel_err(lib(), got)
        torch.cuda.synchronize()
        if e_lib > tol["baseline"]:
            raise SystemExit(f"twin {name}: library call vs hopper "
                             f"{e_lib:.2e} > {tol['baseline']:.0e}")
    del got
    kernel_ms = _time_ms(lambda: ex(env), torch)
    torch_ms = _time_ms(lambda: ex_t(env), torch)
    library_ms = None if lib is None else _time_ms(lib, torch)
    nbytes, ops = plan_work(res.plan, env, np.dtype(dt).itemsize)
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    p4 = "none" if phase4_ms is None else f"{phase4_ms:.4f}"
    largest = max(shapes.values(), key=lambda shp: int(np.prod(shp)))
    print(f"twin {name} {dname} {largest}: "
          f"race_kernel on auto, selection hopper, launches {launches}, "
          f"bit-equal to the DSL case (plan {ph}, source {digest[:16]}), "
          f"vs float64 baseline {e_base:.2e} (<= {tol['baseline']:.0e}); "
          f"kernel_ms {kernel_ms:.4f} (phase 4: {p4}), torch_ms "
          f"{torch_ms:.4f}, library_ms {library_ms}, bound_ms "
          f"{bound_ms:.4f} ({by}), share of bound "
          f"{bound_ms / kernel_ms:.3f}, vs torch {e_plan:.2e}, max_abs_err "
          f"{max_abs:.3e}", flush=True)
    return dict(name=f"race_stencil[frontend:{name}]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273", launches=launches,
                max_abs_err=max_abs, ms=kernel_ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms)


def obs_trace(torch) -> None:
    """Phase 11's traced run: the j3d27pt twin at n = 512 captured,
    traced, run three times and differentiated with obs on (fresh
    executors and adjoint build, so every phase records its span), dumped
    to ``build/obs/OBS_metrics.json`` and checked by the report CLI."""
    import numpy as np

    from repro_torch import clear_cache, obs, race_kernel
    from repro_torch.apps import get_case
    from repro_torch.apps.frontend_kernels import TWINS
    from repro_torch.core import adjoint
    from repro_torch.testing import build_env, env_to_torch

    case = get_case("j3d27pt", 512)
    env = env_to_torch(build_env(case, np.float32, seed=0), DEVICE)
    clear_cache()
    adjoint._builds.clear()
    obs.reset()
    obs.configure(enabled=True)
    kern = race_kernel(TWINS["j3d27pt"], reassociate=case.reassociate)
    kern.trace({k: tuple(v.shape) for k, v in env.items()})
    for _ in range(3):
        kern.run(env, device=DEVICE)
    u = env["u"].clone().requires_grad_()
    out = kern.run({**env, "u": u}, device=DEVICE)
    torch.autograd.grad(sum(v.sum() for v in out.values()), [u])
    torch.cuda.synchronize()
    obs.configure(enabled=False)
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    dump = out_dir / "OBS_metrics.json"
    obs.dump(dump)
    obs.reset()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(dump),
         "--require-spans", OBS_SPANS, "--trace-out",
         str(out_dir / "OBS_trace.json")],
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"obs report exited {proc.returncode}:\n"
                         f"{proc.stderr}")


def obs_cost(torch) -> None:
    """Phase 11's host cost of obs: µs per call of :data:`OBS_CALLS` calls
    of the executor's ``run``, ``res.run`` and ``race_kernel.run`` on one
    j3d27pt_b256 example (n = 64), obs off and on in turns (off, on, on,
    off, twice); each round's numbers, then the medians."""
    import numpy as np

    from repro_torch import compile_plan, obs, race, race_kernel
    from repro_torch.apps import get_case
    from repro_torch.apps.frontend_kernels import TWINS
    from repro_torch.testing import build_env, env_to_torch

    case = get_case("j3d27pt", 64)
    env = env_to_torch(build_env(case, np.float32, seed=0), DEVICE)
    res = race(case.program, reassociate=case.reassociate)
    kern = race_kernel(TWINS["j3d27pt"], reassociate=case.reassociate)
    ex = compile_plan(res.plan, env)
    calls = {"executor.run": lambda: ex(env),
             "res.run": lambda: res.run(env, device=DEVICE),
             "race_kernel.run": lambda: kern.run(env, device=DEVICE)}

    def per_call_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OBS_CALLS * 1e6

    rounds = {False: [], True: []}
    for on in (False, True, True, False) * 2:
        obs.configure(enabled=on)
        us = {label: per_call_us(fn) for label, fn in calls.items()}
        rounds[on].append(us)
        print(f"obs {'on ' if on else 'off'}: {OBS_CALLS} calls each, us "
              f"per call: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       us.items()), flush=True)
    obs.reset()
    for label in calls:
        off = statistics.median(r[label] for r in rounds[False])
        on = statistics.median(r[label] for r in rounds[True])
        print(f"obs cost {label}: off {off:.2f} us, on {on:.2f} us per call "
              f"(medians of {len(rounds[False])} rounds), on - off "
              f"{on - off:.2f} us", flush=True)


def shape_env(case, dt) -> dict:
    """The case's env without its outputs as ``meta`` tensors: a signature
    (what the tuner keys on and renders sources for) with no data."""
    import numpy as np
    import torch

    from repro_torch.core.codegen import required_shapes

    outs = {st.lhs.name for st in case.program.body}
    dtype = getattr(torch, np.dtype(dt).name)
    return {k: torch.empty(shp, dtype=dtype, device="meta")
            for k, shp in required_shapes(case.program).items()
            if k not in outs}


def tuning_cells() -> list:
    """Phase 12's cells: (label, case, dtype, batch sizes)."""
    import numpy as np

    from repro_torch.apps import get_case

    cells = [(name, n, ()) for name, n in TUNE_CELLS]
    cells.append(TUNE_SERVE_CELL + (TUNE_BATCH_SIZES,))
    return [(f"{name} n={n}", get_case(name, n), np.float32, bs)
            for name, n, bs in cells]


def tune_opts(case, batch_sizes=()) -> dict:
    """The search of phase 12: levels {0, default}, both backends, the
    port's tile grid, the case's level as the default."""
    return dict(levels=(0, case.reassociate),
                default_reassociate=case.reassociate,
                batch_sizes=batch_sizes)


def k1_executors(plans) -> list:
    """The cached K1 executors of these plans (any signature, any tile)."""
    from repro_torch import executor_cache, plan_hash

    hashes = {plan_hash(p) for p in plans}
    return [ex for ex in executor_cache().executors()
            if ex.spec is not None and plan_hash(ex.plan) in hashes]


def tune_main(label, case, dt, batch_sizes, torch):
    """Phase 12 for one cell: ``autotune`` on a fresh store; returns the
    decision."""
    from repro_torch import race

    from repro_torch.tuning import autotune

    env = batch_envs(case, dt, 1)[0]
    plans = [race(case.program, reassociate=lvl).plan
             for lvl in sorted({0, case.reassociate})]
    for ex in k1_executors(plans):
        ex.spec.launches = 0
    dec = autotune(case.program, env, device=DEVICE,
                   **tune_opts(case, batch_sizes))
    torch.cuda.synchronize()
    if dec.from_cache:
        raise SystemExit(f"tune {label}: answered from the store, which "
                         f"should be empty")
    for m in dec.measurements:
        us = "-" if m.us is None else f"{m.us:.2f}"
        err = "-" if m.rel_err is None else f"{m.rel_err:.2e}"
        print(f"tune {label} {m.config.describe()} batch {m.batch}: "
              f"{m.status} rel_err {err} us {us} {m.detail}", flush=True)
    hopper = [m for m in dec.measurements if m.config.backend == "hopper"
              and m.status != "error"]
    launches = sum(ex.kernel_launches for ex in k1_executors(plans))
    winner = next((m for m in dec.measurements if m.ok and m.batch == 0
                   and m.config == dec.choice), None)
    print(f"tune {label}: default {dec.default.describe()} "
          f"{dec.default_us:.2f} us, winner {dec.choice.describe()} "
          f"{dec.tuned_us:.2f} us (x{dec.default_us / dec.tuned_us:.3f}), "
          f"search {dec.search_seconds:.2f} s, {len(dec.measurements)} "
          f"candidates, K1 launches {launches} over {len(hopper)} kernel "
          f"candidates ({launches / max(1, len(hopper)):.1f} each)",
          flush=True)
    if winner is None:
        raise SystemExit(f"tune {label}: the winner did not pass the gate")
    if dec.tuned_us > dec.default_us * 1.03:
        raise SystemExit(f"tune {label}: the winner is slower than the "
                         f"default beyond the noise margin")
    bad = [m for m in dec.measurements if m.status == "error"
           and "tile-extent" not in m.detail and "hopper-smem" not in m.detail]
    if bad:
        raise SystemExit(f"tune {label}: candidates failed: "
                         + "; ".join(f"{m.config.describe()}: {m.detail}"
                                     for m in bad))
    return dec


def store_hit(torch) -> None:
    """``--store-hit`` (phase 12's fresh process): every cell of
    :func:`tuning_cells` answers from the store with no measurement, and
    ``"auto"`` builds each winner's executor with its plan record's blocks
    and launches K1 once; prints one JSON line with the nvcc runs, and
    exits non-zero on any miss."""
    from repro_torch import compile_plan, plan_hash, race
    from repro_torch.core import compile_cache
    from repro_torch.core.executor import host_signature
    from repro_torch.serve.warm import synthetic_env
    from repro_torch.tuning import (autotune, plan_choice, record_key,
                                    runtime_fence)

    cells, failures = [], []
    for label, case, dt, batch_sizes in tuning_cells():
        sig = host_signature(shape_env(case, dt))
        env = synthetic_env(sig, DEVICE)
        dec = autotune(case.program, env, device=DEVICE,
                       **tune_opts(case, batch_sizes))
        res = race(case.program, reassociate=dec.choice.reassociate)
        rec = plan_choice(record_key("plan", plan_hash(res.plan), sig,
                                     runtime_fence(DEVICE)))
        ex = compile_plan(res.plan, env)
        blocks = [rec.get(k, 0) for k in ("block_rows", "block_cols",
                                          "block_inner")] if rec else None
        record_ex = None if rec is None else compile_plan(
            res.plan, env, rec["backend"], block_rows=blocks[0],
            block_cols=blocks[1], block_inner=blocks[2])
        launches = None
        if ex.spec is not None:
            ex.spec.launches = 0
            res.run(env, device=DEVICE)
            torch.cuda.synchronize()
            launches = ex.kernel_launches
        cell = dict(cell=label, from_cache=dec.from_cache,
                    measurements=len(dec.measurements),
                    choice=dec.choice.describe(), record=rec,
                    backend=ex.backend, record_executor=record_ex is ex,
                    launches=launches)
        cells.append(cell)
        if not (dec.from_cache and not dec.measurements
                and record_ex is ex and ex.backend == "hopper"
                and launches == 1):
            failures.append(cell)
    nvcc = compile_cache.counts()["misses"]
    print(json.dumps({"store_hit": cells, "nvcc_runs": nvcc}), flush=True)
    if failures or nvcc:
        raise SystemExit(f"store hit failed: {failures}, {nvcc} nvcc runs")


def tuned_check(case, dt, dec, torch) -> dict:
    """Phase 12 after the fresh process: ``race(program).run(env)`` on
    ``"auto"`` with real data builds the executor of the plan record, launches
    K1 once and agrees with ``"torch"`` within ``plan``; the tuned and the
    chooser's kernel are timed; returns the kernel line."""
    import numpy as np

    from repro_torch import compile_plan, race
    from repro_torch.testing import default_tolerances, env_to_torch, rel_err

    dname = np.dtype(dt).name
    res = race(case.program, reassociate=dec.choice.reassociate)
    env = env_to_torch(batch_envs(case, dt, 1)[0], DEVICE)
    ex = compile_plan(res.plan, env)
    if ex.backend != "hopper":
        raise SystemExit(f"tuned {case.name}: auto runs {ex.backend}")
    ex.spec.launches = 0
    got = res.run(env, device=DEVICE)
    torch.cuda.synchronize()
    launches = ex.kernel_launches
    ex_t = compile_plan(res.plan, env, "torch")
    plain = ex_t(env)
    e_plan = rel_err(got, plain)
    max_abs = max(float((got[k].double() - plain[k].double()).abs().max())
                  for k in plain)
    tol = default_tolerances(dt)["plan"]
    if launches != 1 or e_plan > tol:
        raise SystemExit(f"tuned {case.name}: {launches} launches, vs torch "
                         f"{e_plan:.2e} (<= {tol:.0e})")
    del got, plain
    chooser = compile_plan(race(case.program,
                                reassociate=case.reassociate).plan, env,
                           "hopper")
    lib = library_call(case, env)
    ms = _time_ms(lambda: ex(env), torch)
    default_ms = _time_ms(lambda: chooser(env), torch)
    torch_ms = _time_ms(lambda: ex_t(env), torch)
    library_ms = None if lib is None else _time_ms(lib, torch)
    nbytes, ops = plan_work(res.plan, env, np.dtype(dt).itemsize)
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
    g = ex.spec.tp.geometry
    print(f"tuned {case.name} {dname}: {dec.choice.describe()}, plane tile "
          f"{tuple(g.tile[l - 1] for l in g.order)} (levels {g.order}), "
          f"segment {g.seg}, launches {launches}, vs torch {e_plan:.2e}; "
          f"kernel_ms {ms:.4f}, chooser's kernel_ms {default_ms:.4f} "
          f"(x{default_ms / ms:.3f}), torch_ms {torch_ms:.4f}, library_ms "
          f"{library_ms}, bound_ms {bound_ms:.4f} ({by}), share of bound "
          f"{bound_ms / ms:.3f}", flush=True)
    return dict(name=f"race_stencil[tuned:{case.name}]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273", launches=launches,
                max_abs_err=max_abs, ms=ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
                chooser_ms=default_ms, config=dec.choice.describe())


def store_cost(torch) -> None:
    """Phase 12's last step: the host's µs per call that ``"auto"`` pays
    for the store consult (one ``os.stat`` of the store file, the memoized
    key, the record), on the serving cell with its record: ``compile_plan``
    and ``res.run`` on ``"auto"`` beside an explicit ``"hopper"``, 2,000
    (``compile_plan``) and 500 (``run``) calls each ending in a
    synchronize, in turns (auto, hopper, hopper, auto)."""
    import numpy as np

    from repro_torch import compile_plan, race
    from repro_torch.apps import get_case
    from repro_torch.testing import env_to_torch

    case = get_case(*TUNE_SERVE_CELL)
    res = race(case.program, reassociate=case.reassociate)
    env = env_to_torch(batch_envs(case, np.float32, 1)[0], DEVICE)

    def per_call(fn, n) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    calls = {"auto": (lambda: compile_plan(res.plan, env),
                      lambda: res.run(env, device=DEVICE)),
             "hopper": (lambda: compile_plan(res.plan, env, "hopper"),
                        lambda: res.run(env, "hopper", device=DEVICE))}
    got = {b: ([], []) for b in calls}
    for b in ("auto", "hopper", "hopper", "auto"):
        got[b][0].append(per_call(calls[b][0], 2000))
        got[b][1].append(per_call(calls[b][1], 500))
    print("store consult, host us per call (j3d27pt n=64, two rounds): "
          + ", ".join(f"compile_plan {b} {a[0]:.2f} / {a[1]:.2f}, res.run "
                      f"{b} {r[0]:.2f} / {r[1]:.2f}"
                      for b, (a, r) in got.items()), flush=True)


def serve_clients(rt, res, pool, refs, concurrency, requests) -> tuple:
    """Closed-loop clients: ``concurrency`` threads, each submitting one
    blocking request at a time; every response is held bit for bit against
    the reference of its env.  Returns (latencies µs, mismatches, errors,
    wall seconds)."""
    import threading

    import numpy as np

    per_client = requests // concurrency
    lock = threading.Lock()
    lat, mism, errors = [], [], []

    def client(idx: int) -> None:
        mine = []
        for i in range(per_client):
            j = (idx * per_client + i) % len(pool)
            t0 = time.perf_counter()
            try:
                out = rt.run(res, pool[j], timeout=300)
            except Exception as e:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(repr(e))
                return
            mine.append((time.perf_counter() - t0) * 1e6)
            if not all(np.array_equal(out[k], refs[j][k]) for k in refs[j]):
                with lock:
                    mism.append(j)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, mism, errors, time.perf_counter() - t0


def _pct(lat, q) -> float:
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(q * len(lat)))]


def batch_split(label, case, dt, res, pool, torch) -> dict:
    """Where one coalesced batch of 32 goes, step by step as the runtime
    dispatches it: host stack, host-to-device copy, K1 (CUDA events),
    device-to-host copy, fan-out; then K1 beside its plain version, the
    library call and the bound; returns the kernel line."""
    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.core.executor import host_signature
    from repro_torch.testing import default_tolerances, rel_err

    B = 32
    dname = np.dtype(dt).name
    envs = [pool[b % len(pool)] for b in range(B)]
    sig = host_signature(envs[0])
    # the executor the runtime resolves for a coalesced batch of B
    ex = compile_plan(res.plan, sig, "auto", device=DEVICE, batch=B)
    split = {}
    for _ in range(2):  # the second of two, after a warm round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = {}
        for k in envs[0]:
            first = np.asarray(envs[0][k])
            a = np.empty((B,) + first.shape, dtype=first.dtype)
            for b, e in enumerate(envs):
                a[b] = e[k]
            host[k] = a
        t1 = time.perf_counter()
        dev = {k: torch.from_numpy(a).to(DEVICE) for k, a in host.items()}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ex.run_batch(dev)
        end.record()
        end.synchronize()
        t3 = time.perf_counter()
        host_out = {k: v.cpu().numpy() for k, v in out.items()}
        t4 = time.perf_counter()
        fan = [{k: host_out[k][b] for k in host_out} for b in range(B)]
        t5 = time.perf_counter()
        split = dict(host_stack_ms=(t1 - t0) * 1e3, h2d_ms=(t2 - t1) * 1e3,
                     k1_ms=start.elapsed_time(end),
                     k1_host_ms=(t3 - t2) * 1e3, d2h_ms=(t4 - t3) * 1e3,
                     fanout_ms=(t5 - t4) * 1e3, total_ms=(t5 - t0) * 1e3)
        del fan
    in_bytes = sum(a.nbytes for a in host.values())
    out_bytes = sum(a.nbytes for a in host_out.values())
    print(f"serve-split {label} B={B} ({ex.backend}, blocks "
          f"{ex.spec.tp.geometry.tile if ex.spec else None}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; in {in_bytes} B ({in_bytes / split['h2d_ms'] / 1e6:.2f} "
          f"GB/s), out {out_bytes} B ({out_bytes / split['d2h_ms'] / 1e6:.2f}"
          f" GB/s)", flush=True)
    if ex.backend != "hopper":
        raise SystemExit(f"serve {label}: a batch of {B} runs {ex.backend}")
    ex_t = compile_plan(res.plan, sig, "torch", device=DEVICE)
    plain = ex_t.run_batch(dev)
    got = ex.run_batch(dev)
    torch.cuda.synchronize()
    e_plan = rel_err(got, plain)
    max_abs = max(float((got[k].double() - plain[k].double()).abs().max())
                  for k in plain)
    for b in SERVE_MAX_BATCH:  # the runtime's batch limits
        part = {k: v[:b] for k, v in dev.items()}
        geometry_turns(f"serve:{label} B={b}", res.plan, sig, b,
                       lambda e: e.run_batch(part),
                       {k: v[:b] for k, v in got.items()},
                       default_tolerances(dt)["plan"], torch)
    del got, plain
    lib = library_call(case, dev)
    ms = _time_ms(lambda: ex.run_batch(dev), torch)
    torch_ms = _time_ms(lambda: ex_t.run_batch(dev), torch)
    library_ms = None if lib is None else _time_ms(lib, torch)
    example = {k: v[0] for k, v in dev.items()}
    nbytes, ops = plan_work(res.plan, example, np.dtype(dt).itemsize)
    bound_ms, by = bound_of(nbytes * B, ops * B, PEAK_FLOPS[dname])
    print(f"serve-kernel {label} B={B}: kernel_ms {ms:.4f}, torch batched "
          f"ms {torch_ms:.4f}, library_ms {library_ms}, bound_ms "
          f"{bound_ms:.4f} ({by}), share of bound {bound_ms / ms:.3f}, vs "
          f"torch {e_plan:.2e}", flush=True)
    if e_plan > default_tolerances(dt)["plan"]:
        raise SystemExit(f"serve {label}: a batch of {B} on K1 is "
                         f"{e_plan:.2e} from \"torch\"")
    return dict(name=f"race_stencil[serve:{label}]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273",
                max_abs_err=max_abs, ms=ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
                batch=B, split=split)


def serve_main(label, name, n, dname, pool_size, torch) -> dict:
    """Phase 13 for one cell: ``ServeRuntime`` on ``"auto"`` at each
    concurrency and batch limit, then a plain loop of ``res.run``, then the
    split of one batch of 32; returns the kernel line (``launches``: K1's
    launches over every setting, each setting's count zeroed just before
    and equal to its batches)."""
    import numpy as np

    from repro_torch import race
    from repro_torch.apps import get_case
    from repro_torch.serve import ServeRuntime

    dt = np.dtype(dname).type
    case = get_case(name, n)
    res = race(case.program, reassociate=case.reassociate)
    pool = batch_envs(case, dt, pool_size)
    refs = [{k: v.cpu().numpy() for k, v in res.run(e, device=DEVICE).items()}
            for e in pool]
    total = 0
    for mb in SERVE_MAX_BATCH:
        for conc in SERVE_CONCURRENCY:
            requests = (SERVE_LONG.get(label, SERVE_REQUESTS)
                        if (conc, mb) == SERVE_FULL
                        else SERVE_SHORT.get(label, SERVE_REQUESTS))
            with ServeRuntime(max_batch=mb, device=DEVICE) as rt:
                rt.warmup([(res, pool[0])])
                torch.cuda.synchronize()
                for ex in k1_executors([res.plan]):
                    ex.spec.launches = 0
                s0 = rt.stats()
                lat, mism, errors, wall = serve_clients(
                    rt, res, pool, refs, conc, requests)
                torch.cuda.synchronize()
                s1 = rt.stats()
            d = {k: s1[k] - s0[k] for k in ("batches", "coalesced",
                                            "rejected", "completed")}
            launches = sum(ex.kernel_launches
                           for ex in k1_executors([res.plan]))
            total += launches
            print(f"serve {label} {dname} concurrency {conc} max_batch {mb}:"
                  f" {len(lat)} requests, p50 {_pct(lat, 0.5):.1f} us, p95 "
                  f"{_pct(lat, 0.95):.1f} us, rps "
                  f"{len(lat) / wall:.1f}, batches {d['batches']}, "
                  f"coalesced {d['coalesced']}, largest batch "
                  f"{s1['max_batch']}, rejected {d['rejected']}, K1 "
                  f"launches {launches}, mismatches {len(mism)}",
                  flush=True)
            if errors or mism or d["rejected"] or launches != d["batches"]:
                raise SystemExit(
                    f"serve {label} c{conc} mb{mb}: errors {errors[:2]}, "
                    f"{len(mism)} responses differ from run, rejected "
                    f"{d['rejected']}, K1 launches {launches} vs batches "
                    f"{d['batches']}")
    lat = []
    t_loop = time.perf_counter()
    for i in range(SERVE_LONG.get(label, SERVE_REQUESTS)):
        t0 = time.perf_counter()
        out = res.run(pool[i % len(pool)], device=DEVICE)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        lat.append((time.perf_counter() - t0) * 1e6)
    wall = time.perf_counter() - t_loop
    del out, host
    print(f"serve {label} plain loop of res.run + copy to the host: "
          f"{len(lat)} requests, p50 {_pct(lat, 0.5):.1f} us, p95 "
          f"{_pct(lat, 0.95):.1f} us, rps {len(lat) / wall:.1f}",
          flush=True)
    line = batch_split(label, case, dt, res, pool, torch)
    line["launches"] = total
    return line


def serve_tools(n_records: int) -> None:
    """Phase 13's last step: fresh processes run the warm CLI on phase 12's
    store (every record warmed, none unmatched, no nvcc run) and the serve
    launcher (its row printed)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    # a string hash seed under which the reference derives another j3d27pt
    # plan (ROADMAP F7): the port's plans must not follow it
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.warm", "--json", "-",
         "--device", DEVICE],
        env=dict(env, PYTHONHASHSEED="4"), capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"serve.warm exited {proc.returncode}:\n"
                         f"{proc.stderr[-4000:]}")
    doc = json.loads(proc.stdout)
    for rep in doc["warmed"]:
        print(f"warm plan {rep['plan']} {rep['backend']} blocks "
              f"{rep['blocks']}: build {rep['build_ms']} ms, first "
              f"{rep['first_ms']} ms, library hits {rep['cache_hits']}, "
              f"nvcc runs {rep['cache_misses']}", flush=True)
    cc = doc["compile_cache"]
    print(f"warm: {len(doc['warmed'])} of {n_records} records warmed, "
          f"unmatched {doc['unmatched']}, nvcc runs {cc['misses']}, "
          f"library hits {cc['hits']}", flush=True)
    if (doc["unmatched"] or len(doc["warmed"]) != n_records
            or cc["misses"]):
        raise SystemExit("serve.warm did not warm every record from the "
                         "library directory")
    from repro_torch.core import compile_cache

    libs = set(Path(compile_cache.cache_dir()).glob("*.so"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--case",
         "j3d27pt", "--n", "64", "--requests", "256", "--concurrency", "8",
         "--device", DEVICE],
        env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith(
            "serve j3d27pt n=64"):
        raise SystemExit(f"launch.serve exited {proc.returncode}:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    built = sorted(p.name for p in set(Path(
        compile_cache.cache_dir()).glob("*.so")) - libs)
    print(f"launch.serve: {lines[-1]}; libraries it built: {built}",
          flush=True)


def shard_mesh(torch):
    """Phase 14's 2x2 mesh: four distinct cards where there are four, else
    the first card four times (one process, one controller)."""
    from repro_torch.launch.mesh import make_stencil_mesh

    if torch.cuda.device_count() >= 4:
        return make_stencil_mesh(4)
    return make_stencil_mesh(devices=["cuda:0"] * 4)


def shard_sources(mesh) -> list:
    """The K1 sources phase 14 runs, built in phase 2: each forward cell's
    local plan (one source, whichever halo strategy), and each adjoint
    spec's local plan where the partitioner admits its program (a refused
    spec runs its single-device adjoint plan, whose source phase 6 has).
    The executors go into a cache of their own: phases 10 and 12 read the
    process-wide one and expect single-device executors only."""
    import numpy as np

    from repro_torch import env_signature, race
    from repro_torch.core.executor import ExecutorCache
    from repro_torch.apps import get_case
    from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
    from repro_torch.core.codegen import required_shapes
    from repro_torch.shard import ShardingUnavailable, compile_sharded

    out = []
    cache = ExecutorCache()
    for name, n in SHARD_CELLS:
        case = get_case(name, n)
        res = race(case.program, reassociate=case.reassociate)
        sr = compile_sharded(res, env_signature(shape_env(case, np.float32)),
                             mesh, cache=cache)
        if sr.backend != "hopper":
            raise SystemExit(f"sharded {name}: the local plan is on "
                             f"{sr.backend}: "
                             f"{sr.local.selection.capability.explain()}")
        out += [ex.spec.source for ex in sr.locals.values()]
    case = get_case(*SHARD_GRAD_CELL)
    outs = {st.lhs.name for st in case.program.body}
    shapes = {k: v for k, v in required_shapes(case.program).items()
              if k not in outs}
    for spec in adjoint_build(case.program).specs:
        adj = adjoint_env_shapes(spec, case.program, shapes)
        sig = tuple((k, tuple(adj[k]), "float32") for k in sorted(adj))
        try:
            sr = compile_sharded(spec.result(), sig, mesh, cache=cache)
        except ShardingUnavailable:
            continue
        out += [ex.spec.source for ex in sr.locals.values()
                if ex.spec is not None]
    return out


def _wall_ms(fn, torch) -> float:
    """Median over REPS of one call by the host clock, every card
    synchronized before and after (CUDA events time one card's stream;
    a mesh over several cards needs them all), after a warm-up."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fn()
    sync()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _shard_timer(sr):
    """CUDA events where every shard is on one card, else the host clock
    with every card synchronized."""
    return _time_ms if len(sr.locals) == 1 else _wall_ms


def _zero_launches(executors) -> None:
    """Zero the K1 launch counts of single-device executors and of every
    local executor of sharded ones."""
    for ex in executors:
        for local in getattr(ex, "locals", {None: ex}).values():
            if local.spec is not None:
                local.spec.launches = 0


def shard_main(name, n, mesh, torch) -> dict:
    """Phase 14's forward for one cell; returns its kernel line (the four
    local K1 launches of one ``"auto"`` call)."""
    import numpy as np

    from repro_torch import compile_plan, plan_hash, race
    from repro_torch.apps import get_case
    from repro_torch.core.codegen import interior
    from repro_torch.shard import compile_sharded
    from repro_torch.testing import build_env, default_tolerances, rel_err

    case = get_case(name, n)
    dt = np.float32
    tol = default_tolerances(dt)
    outs = {st.lhs.name for st in case.program.body}
    env = {k: torch.as_tensor(v, device=DEVICE)
           for k, v in build_env(case, dt, seed=0).items() if k not in outs}
    res = race(case.program, reassociate=case.reassociate)
    ex1 = compile_plan(res.plan, env, "hopper")
    want = ex1(env)
    env64 = {k: v.double() for k, v in env.items()}
    truth = interior(res.plan, res.baseline_evaluator()(env64))
    del env64
    torch.cuda.synchronize()
    single_ms = _time_ms(lambda: res.run(env, device=DEVICE), torch)
    single_kernel_ms = _time_ms(lambda: ex1(env), torch)
    line = None
    for halo in ("exchange", "recompute", "auto"):
        res_m = race(case.program, reassociate=case.reassociate, mesh=mesh,
                     halo=halo)
        sr = compile_sharded(res_m, env, mesh, halo=halo)
        hp = sr.halo_prog
        if sr.backend != "hopper":
            raise SystemExit(f"sharded {name} {halo}: local backend "
                             f"{sr.backend}")
        _zero_launches([sr])
        got = res_m.run(env)
        torch.cuda.synchronize()
        launches = sr.kernel_launches
        if launches != mesh.size:
            raise SystemExit(f"sharded {name} {halo}: {launches} K1 "
                             f"launches for {mesh.size} shards")
        e_plan = rel_err(got, want)
        e_base = rel_err(got, truth)
        max_abs = max(float((got[k].double() - want[k].double()).abs().max())
                      for k in want)
        ok = e_plan <= tol["plan"] and e_base <= tol["baseline"]
        del got
        sharded_ms = _shard_timer(sr)(lambda: res_m.run(env), torch)
        print(f"shard {name} n={n} f32 halo={halo}: strategy {hp.strategy}, "
              f"local backend {sr.backend}, partition "
              f"{sr.partition.key()}, local plan "
              f"{plan_hash(sr.local.plan)} (global {plan_hash(res.plan)}), "
              f"K1 launches per call {launches}, halo_bytes "
              f"{hp.halo_bytes}, restack_bytes {hp.restack_bytes}, "
              f"slab_bytes {hp.slab_bytes}; vs single-device hopper "
              f"{e_plan:.2e} (<= {tol['plan']:.0e}), vs float64 baseline "
              f"{e_base:.2e} (<= {tol['baseline']:.0e}), max_abs_err "
              f"{max_abs:.3e}; sharded_ms {sharded_ms:.4f}, single-device "
              f"res.run ms {single_ms:.4f} (its kernel {single_kernel_ms:.4f})"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"sharded {name} {halo} disagrees")
        if halo == "auto":
            line = shard_parts(name, n, case, env, sr, launches, max_abs,
                               sharded_ms, single_ms, torch)
    return line


def shard_parts(name, n, case, env, sr, launches, max_abs, sharded_ms,
                single_ms, torch) -> dict:
    """Phase 14's split of one sharded call into its glue and its kernels:
    the prologue (local slabs, halo copies), the local K1 launches, the
    epilogue (local interiors into the global outputs), each timed alone;
    the local plans on ``"torch"``; the bound of the four local calls."""
    import numpy as np

    from repro_torch import compile_plan

    hp, shards = sr.halo_prog, sr.shards
    local_sig = sr.local.env_sig
    envs = hp.local_envs(env, shards)
    cores = [sr.locals[str(dev)].core_fn for _, dev in shards]
    plains = [compile_plan(sr.local.plan, local_sig, "torch", device=dev)
              for _, dev in shards]
    louts = [core(e) for core, e in zip(cores, envs)]
    nbytes = ops = 0
    for e in envs:
        b, o = plan_work(sr.local.plan, e, np.dtype(np.float32).itemsize)
        nbytes, ops = nbytes + b, ops + o
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS["float32"])
    lib = library_call(case, env)
    library_ms = None if lib is None else _time_ms(lib, torch)
    timer = _shard_timer(sr)

    def run_shards(fns):
        for fn, e, (_, dev) in zip(fns, envs, shards):
            with torch.cuda.device(dev):
                fn(e)

    prologue_ms = timer(lambda: hp.local_envs(env, shards), torch)
    k1_ms = timer(lambda: run_shards(cores), torch)
    plain_ms = timer(lambda: run_shards(plains), torch)
    epilogue_ms = timer(lambda: hp.assemble(louts, shards, sr.device), torch)
    parts = prologue_ms + k1_ms + epilogue_ms
    print(f"shard-split {name} n={n} ({hp.strategy}, {len(shards)} shards "
          f"on {len(sr.locals)} card(s), {timer.__name__}): prologue_ms "
          f"{prologue_ms:.4f}, K1 x{len(shards)} ms {k1_ms:.4f}, "
          f"epilogue_ms {epilogue_ms:.4f}, sum {parts:.4f}; whole call "
          f"{sharded_ms:.4f}, single-device res.run {single_ms:.4f} "
          f"(sharded / single {sharded_ms / single_ms:.3f}); local plans on "
          f"torch x{len(shards)} {plain_ms:.4f}; bytes {nbytes}, bound_ms "
          f"{bound_ms:.4f} ({by}), share of bound {bound_ms / k1_ms:.3f}, "
          f"library_ms {library_ms}", flush=True)
    return dict(name=f"race_stencil[{name} sharded 2x2]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273", launches=launches,
                max_abs_err=max_abs, ms=k1_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=library_ms)


def shard_grad(mesh, torch) -> None:
    """Phase 14's gradient: ``torch.autograd.grad`` through the sharded
    ``run`` against the same gradient through the single-device ``run``
    within ``grad``; per adjoint spec, sharded or fallen back and its K1
    launches in one backward (zeroed just before)."""
    import numpy as np

    from repro_torch import race
    from repro_torch.apps import get_case
    from repro_torch.shard import ShardedRace, compile_sharded
    from repro_torch.testing import build_env, default_tolerances, rel_err

    case = get_case(*SHARD_GRAD_CELL)
    outs = {st.lhs.name for st in case.program.body}
    env = {k: torch.as_tensor(v, device=DEVICE)
           for k, v in build_env(case, np.float32, seed=0).items()
           if k not in outs}
    keys = sorted(k for k, v in env.items() if v.is_floating_point())
    res = race(case.program, reassociate=case.reassociate)
    res_m = race(case.program, reassociate=case.reassociate, mesh=mesh)
    runs = {}
    for label, r in (("single", res), ("sharded", res_m)):
        p = {k: env[k].clone().requires_grad_() for k in keys}
        out = (r.run({**env, **p}) if label == "sharded"
               else r.run({**env, **p}, device=DEVICE))
        g = cos_weights(out, torch)

        def bwd(out=out, p=p, g=g):
            return torch.autograd.grad([out[k] for k in g],
                                       [p[k] for k in keys],
                                       [g[k] for k in g], retain_graph=True,
                                       allow_unused=True)

        runs[label] = (bwd, bwd())
    torch.cuda.synchronize()
    sr = compile_sharded(res_m, env, mesh, halo="auto")
    adj = sr.adjoint_executors()
    _zero_launches(adj.values())
    bwd, _ = runs["sharded"]
    grads = bwd()
    torch.cuda.synchronize()
    single = dict(zip(keys, runs["single"][1]))
    got = dict(zip(keys, grads))
    e = rel_err({k: v for k, v in got.items() if v is not None},
                {k: single[k] for k, v in got.items() if v is not None})
    tol = default_tolerances(np.float32)["grad"]
    specs = []
    bad = []
    for inp, ex in sorted(adj.items()):
        n_launch = ex.kernel_launches
        sharded = isinstance(ex, ShardedRace)
        want = mesh.size if sharded else 1
        specs.append(f"{inp} {'sharded' if sharded else 'fallback'} "
                     f"{ex.backend} launches {n_launch}")
        if ex.backend != "hopper" or n_launch != want:
            bad.append(inp)
    single_ms = _time_ms(runs["single"][0], torch)
    sharded_ms = _shard_timer(sr)(bwd, torch)
    print(f"shard-grad {SHARD_GRAD_CELL[0]} n={SHARD_GRAD_CELL[1]} f32: "
          f"specs: {'; '.join(specs)}; grads vs single-device {e:.2e} (<= "
          f"{tol:.0e}); backward_ms sharded {sharded_ms:.4f}, single-device "
          f"{single_ms:.4f}", flush=True)
    if e > tol or bad or set(adj) != set(keys):
        raise SystemExit(f"sharded gradient failed: rel_err {e:.2e}, specs "
                         f"off K1 or with wrong launches {bad}, specs "
                         f"{sorted(adj)} for inputs {keys}")


def shard_faults(mesh, torch) -> None:
    """Phase 14's fault programs (ROADMAP F14, F15): ``torch.autograd.grad``
    through ``run_sharded`` on ``"hopper"``, without ``allow_unused``,
    against autograd of the float64 baseline (:func:`fault_check`); K1
    launches in the backward where, and only where, a wanted input has an
    adjoint spec (a spec the partitioner admits launches once a shard, a
    refused one once)."""
    import numpy as np

    from repro_torch.core.adjoint import adjoint_build
    from repro_torch.testing import default_tolerances

    tol = default_tolerances(np.float32)["grad"]
    bad = []
    for name, lvl, program, res, wrt in fault_runs(SHARD_FAULT_CELLS):
        env = fault_env(program, torch)
        keys = sorted(k for k, v in env.items() if v.is_floating_point())
        g, want = fault_baseline(program, res, env, keys, torch)
        g = {k: v.float() for k, v in g.items()}
        p = {k: env[k].clone().requires_grad_() for k in wrt}
        out = res.run_sharded({**env, **p}, mesh, "hopper")
        before = k1_launch_counts()
        grads = torch.autograd.grad([out[k] for k in g],
                                    [p[k] for k in wrt], [g[k] for k in g])
        torch.cuda.synchronize()
        launched = k1_launched_since(before)
        specs = any(s.input in wrt for s in adjoint_build(program).specs)
        ok, text = fault_check(name, dict(zip(wrt, grads)), want, env, tol,
                               torch)
        ok &= (launched > 0) == specs
        line = (f"shard-fault {name} r{lvl} hopper float32: wrt, vs float64 "
                f"baseline (<= {tol:.0e}): {text}; K1 launches {launched} "
                f"{'ok' if ok else 'FAIL'}")
        print(line, flush=True)
        if not ok:
            bad.append(line)
    if bad:
        raise SystemExit("sharded fault gradients failed:\n" + "\n".join(bad))


def shard_refusal(mesh, torch) -> None:
    """Phase 14: rprj3's stride-2 reads refuse sharding with
    ``shard-strided``."""
    import numpy as np

    from repro_torch import race
    from repro_torch.apps import get_case
    from repro_torch.shard import S_STRIDED, ShardingUnavailable
    from repro_torch.testing import SWEEP_SIZES, build_env

    case = get_case("rprj3", SWEEP_SCALE * SWEEP_SIZES["rprj3"])
    res = race(case.program, reassociate=case.reassociate, mesh=mesh)
    try:
        res.run(build_env(case, np.float32, seed=0))
    except ShardingUnavailable as err:
        codes = sorted({r.code for r in err.refusals})
        print(f"shard-refusal rprj3: ShardingUnavailable {codes}",
              flush=True)
        if S_STRIDED not in codes:
            raise SystemExit(f"rprj3 refused without {S_STRIDED}: {err}")
        return
    raise SystemExit("rprj3 ran sharded; shard-strided expected")


def copy_bandwidth(torch) -> None:
    """Phase 14: the card's device-to-device copy rate of 1 GiB (and, with
    two cards or more, the peer copy rate from card 0 to card 1)."""
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device="cuda:0")
    b = torch.empty_like(a)
    ms = _time_ms(lambda: b.copy_(a), torch)
    print(f"copy 1 GiB cuda:0 -> cuda:0: {ms:.4f} ms, {n / ms / 1e6:.1f} "
          f"GB/s copied ({2 * n / ms / 1e6:.1f} GB/s read + written)",
          flush=True)
    del b
    if torch.cuda.device_count() >= 2:
        c = torch.empty(n, dtype=torch.uint8, device="cuda:1")
        ms = _time_ms(lambda: c.copy_(a), torch)
        torch.cuda.synchronize(1)
        print(f"copy 1 GiB cuda:0 -> cuda:1: {ms:.4f} ms, "
              f"{n / ms / 1e6:.1f} GB/s", flush=True)


def lm_mixer_cells() -> list:
    """(label, S, channels) of every mixer phase 15 runs: the prefill of
    lm:qwen2-7b, the prefill of lm:parity and qwen2's reduced config."""
    from repro_torch.configs import get_config

    full = get_config(LM_ARCH)
    small = full.reduced()
    return [("qwen2-7b", LM_PROMPT, LM_BATCH * full.d_model),
            ("parity", LM_PARITY_PROMPT, LM_PARITY_BATCH * full.d_model),
            ("families", LM_FAMILY_SHAPE[1],
             LM_FAMILY_SHAPE[0] * small.d_model)]


def lm_sources() -> list:
    """The K1 sources of phase 15's mixers (float32 streams), built in
    phase 2."""
    from repro_torch.core.codegen import required_shapes
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.models.ssm import _smooth_result

    out = []
    for _, S, C in lm_mixer_cells():
        res = _smooth_result(S, C, LM_RADIUS)
        shapes = required_shapes(res.program)
        out.append(specialize_stencil(res.plan, shapes, {
            k: "float32" for k in shapes}).source)
    return out


def _mixer_filter(env, radius: int, device, torch):
    """The mixer's effective (R + 3)-tap filter: ``y[s] = sum_d sw_d
    (x[s+R-d] + x[s+R-d+1] + x[s+R-d+2])`` is one cross-correlation whose
    tap ``k`` sums the ``sw_d`` with ``R - d <= k <= R - d + 2``."""
    w = torch.zeros(radius + 3, dtype=torch.float64)
    for d in range(radius + 1):
        for e in range(3):
            w[radius - d + e] += float(env[f"sw{d}"])
    return w.to(device=device, dtype=torch.float32)


def mixer_library_call(env, radius: int, torch):
    """``F.conv1d`` of the mixer's stream with its effective filter
    (:func:`_mixer_filter`).  The channels become the batch (a transposed
    view)."""
    import torch.nn.functional as F

    w = _mixer_filter(env, radius, env["sx"].device, torch)[None, None]
    x = env["sx"].t()[:, None, :]
    return lambda: {"sy": F.conv1d(x, w)[:, 0].t()}


def sx_adjoint_library_call(adj_env, radius: int, torch):
    """``F.conv1d`` computing the mixer's ``sx`` adjoint plan: ``_adj_sx[q]
    = sum_k w[R + 2 - k] g[q + k]`` over the output gradient ``_g_sy``
    (padded by R + 2 at each end), ``w`` the forward's filter reversed.
    The tap adjoints have theirs in :func:`tap_adjoint_library_call`."""
    import torch.nn.functional as F

    g = adj_env["_g_sy"]
    w = _mixer_filter(adj_env, radius, g.device, torch).flip(0)[None, None]
    x = g.t()[:, None, :]
    return lambda: {"_adj_sx": F.conv1d(x, w)[:, 0].t()}


def tap_adjoint_library_call(adj_env, radius: int, torch,
                             how: str = "conv1d"):
    """One library call computing the mixer's tap adjoints, ``d(loss)/d
    sw_d = sum_{s,c} g[s, c] b(s + R - d, c)`` with ``g`` the output
    gradient ``_g_sy`` (S, C) and ``b(t) = sx[t] + sx[t + 1] + sx[t + 2]``:
    a cross-correlation of two streams summed over the channels, whose
    R + 3 lags ``r[j] = sum_{s,c} g[s, c] sx[s + j, c]`` give every tap,
    tap ``d`` being ``r[R - d] + r[R - d + 1] + r[R - d + 2]``.
    ``how="conv1d"``: one ``F.conv1d`` of ``sx`` (its C channels by S + R
    + 2) with ``g`` as a single filter across every channel.
    ``how="mv"``: one ``torch.mv`` of the (R + 3, S C) matrix whose row
    ``j`` is ``sx``'s rows ``j .. j + S - 1`` (an overlapping strided view,
    which the call copies) with ``g`` flattened.  Returns the taps,
    (R + 1,) float32 (TF32 is off: ``main`` clears it).  ``adj_env`` is a
    tap spec's adjoint env (``sx`` and ``_g_sy``)."""
    import torch.nn.functional as F

    g, sx = adj_env["_g_sy"], adj_env["sx"]
    lags = (torch.arange(radius, -1, -1)[:, None]
            + torch.arange(3)).to(g.device)
    if how == "mv":
        S, C = g.shape
        rows = sx.contiguous().as_strided((radius + 3, S * C), (C, 1))
        flat = g.reshape(-1)
        return lambda: torch.mv(rows, flat)[lags].sum(1)
    x, w = sx.t()[None], g.t()[None]
    return lambda: F.conv1d(x, w)[0, 0][lags].sum(1)


def tap_adjoint_check(label, grp, sw, radius: int, torch) -> tuple:
    """The tap adjoints ``sw0..sw<R>`` on K1 as the backward runs them:
    ``grp``, the ``(group, adjoint env, executor)`` of their scalar group
    (one summed launch, one partial per block for each tap, summed here in
    float64), against :func:`tap_adjoint_library_call` on the same inputs;
    ``sw``, each tap's own ``(spec, adjoint env, executor)`` (one summed
    launch per tap, as before the group), held the same way.  A tap is a
    sum of S C terms of both signs, so float32 sums in any order differ
    from each other by their rounding times ``sum |g b|`` (from the
    ``"torch"`` plans' products), which exceeds the tap itself by ~2e3 at
    these shapes: the gate is ``plan`` (float32) of ``sum |g b|``, and the
    error relative to the largest tap is printed beside it.  Returns (the
    conv1d call, the group's launch, the group's launch with the sums the
    backward takes, the ``torch.mv`` call, the taps' own launches, with
    their sums)."""
    from repro_torch import compile_plan
    from repro_torch.testing import default_tolerances

    group, ga, ge = grp
    names = [f"sw{d}" for d in range(radius + 1)]
    sw = sorted(sw, key=lambda t: int(t[0].input[2:]))
    if [t[0].input for t in sw] != names or [
            m.input for m in group.members] != names:
        raise SystemExit(f"{label}: the tap adjoints are not sw0..sw{radius}")
    lib = tap_adjoint_library_call(sw[0][1], radius, torch)
    mv = tap_adjoint_library_call(sw[0][1], radius, torch, "mv")
    got, got_mv = lib().double(), mv().double()
    before = [e.kernel_launches for e in [ge] + [e for _, _, e in sw]]
    gparts = ge.run_sum(ga)
    parts = [e.run_sum(a)[spec.gu] for spec, a, e in sw]
    torch.cuda.synchronize()
    after = [e.kernel_launches for e in [ge] + [e for _, _, e in sw]]
    if [n - b for n, b in zip(after, before)] != [1] * (radius + 2) or any(
            e.backend != "hopper" for e in [ge] + [e for _, _, e in sw]):
        raise SystemExit(f"{label}: a tap adjoint is off K1 or did not "
                         f"launch")
    n_grp = ge.spec.tp.geometry.n_tiles
    n_tiles = sw[0][2].spec.tp.geometry.n_tiles
    if any(tuple(gparts[m.gu].shape) != (n_grp,) for m in group.members) or \
            any(tuple(p.shape) != (n_tiles,) for p in parts):
        raise SystemExit(f"{label}: the tap adjoints' partials are not one "
                         f"per block ({n_grp}, {n_tiles})")
    k1 = torch.stack([gparts[m.gu].double().sum() for m in group.members])
    own = torch.stack([p.double().sum() for p in parts])
    scale = max(float(compile_plan(spec.result().plan, a, "torch")(a)[
        spec.gu].double().abs().sum()) for spec, a, _ in sw)
    diff = float((got - k1).abs().max())
    diff_mv = float((got_mv - k1).abs().max())
    diff_own = float((own - k1).abs().max())
    tol = default_tolerances("float32")["plan"]

    def fmt(v):
        return [float(f"{x:.6e}") for x in v]

    print(f"{label} tap adjoints sw0..sw{radius} sx "
          f"{tuple(sw[0][1]['sx'].shape)}: K1 group (1 launch, {n_grp} "
          f"partials each) {fmt(k1)}, conv1d {fmt(got)}; |diff| "
          f"{diff:.3e} = {diff / scale:.2e} of sum |g b| {scale:.4e} (<= "
          f"{tol:.0e}), {diff / float(k1.abs().max()):.2e} of the largest "
          f"tap; mv {fmt(got_mv)}, |diff| {diff_mv:.3e} = "
          f"{diff_mv / scale:.2e}; each tap's own launch ({n_tiles} "
          f"partials) {fmt(own)}, |diff| {diff_own:.3e} = "
          f"{diff_own / scale:.2e}; group aux "
          f"{[x.name for x in group.result().plan.aux_order]}, schedule "
          f"{geometry_text(ge.spec.tp.geometry)}", flush=True)
    if not max(diff, diff_mv, diff_own) <= tol * scale:
        raise SystemExit(f"{label}: conv1d or mv and K1 disagree on the "
                         f"tap adjoints")
    del parts, gparts

    def launch():
        ge.run_sum(ga)

    def with_sums():
        out = ge.run_sum(ga)
        return [out[m.gu].sum() for m in group.members]

    def launches():
        for spec, a, e in sw:
            e.run_sum(a)

    def own_sums():
        return [e.run_sum(a)[spec.gu].sum() for spec, a, e in sw]

    return lib, launch, with_sums, mv, launches, own_sums


def lm_mixer_check(x, taps, torch) -> tuple:
    """The mixer of lm:qwen2-7b's prefill on K1 against ``"torch"`` and the
    library call, each timed; returns (its kernel-line entry without the
    launches, K1 ms)."""
    from repro_torch import compile_plan
    from repro_torch.models.ssm import _smooth_result, smooth_env
    from repro_torch.testing import default_tolerances, rel_err

    B, S, C = x.shape
    env = smooth_env(x, taps, LM_RADIUS)
    res = _smooth_result(S, B * C, LM_RADIUS)
    ex = compile_plan(res.plan, env, "hopper")
    ex_t = compile_plan(res.plan, env, "torch")
    before = ex.kernel_launches
    got = ex(env)
    plain = ex_t(env)
    torch.cuda.synchronize()
    if ex.kernel_launches != before + 1:
        raise SystemExit("lm mixer: K1 did not launch")
    tol = default_tolerances("float32")
    e_plan = rel_err(got, plain)
    max_abs = float((got["sy"] - plain["sy"]).abs().max())
    lib = mixer_library_call(env, LM_RADIUS, torch)
    e_lib = rel_err(lib(), got)
    print(f"lm mixer sx {tuple(env['sx'].shape)} float32: K1 vs torch "
          f"{e_plan:.2e} (<= {tol['plan']:.0e}), max_abs_err {max_abs:.3e}; "
          f"conv1d vs K1 {e_lib:.2e} (<= {tol['baseline']:.0e}); aux "
          f"{[a.name for a in res.plan.aux_order]}", flush=True)
    if e_plan > tol["plan"] or e_lib > tol["baseline"]:
        raise SystemExit("lm mixer: K1 disagrees with its plain version or "
                         "the library call")
    kernel_ms = _time_ms(lambda: ex(env), torch)
    torch_ms = _time_ms(lambda: ex_t(env), torch)
    library_ms = _time_ms(lib, torch)
    nbytes, ops = plan_work(res.plan, env, 4)
    bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS["float32"])
    tp = ex.spec.tp
    geo = tp.geometry
    print(f"lm mixer schedule: stream level {geo.s_level}, plane tile "
          f"{tuple(geo.tile[l - 1] for l in geo.order)} (levels "
          f"{geo.order}), segment {geo.seg}, warm-up {-geo.k0}, blocks "
          f"{geo.n_tiles}, smem {tp.smem_bytes} B, aux_evals_per_point "
          f"{tp.aux_evals_per_point:.3f}", flush=True)
    print(f"lm mixer: kernel_ms {kernel_ms:.4f}, torch_ms {torch_ms:.4f}, "
          f"library_ms (conv1d) {library_ms:.4f}, bytes {nbytes}, bound_ms "
          f"{bound_ms:.4f} ({by}), share of bound "
          f"{bound_ms / kernel_ms:.3f}", flush=True)
    return dict(name="race_stencil[race_smooth]", route="cuda",
                source="src/repro_torch/lowering/emit.py",
                replaces="src/repro/lowering/emit.py:273",
                max_abs_err=max_abs, ms=kernel_ms, plain_ms=torch_ms,
                bound_ms=bound_ms, bound_by=by,
                library_ms=library_ms), kernel_ms


def mixer_executor(model, cfg, tokens):
    """The executor ``race_smooth`` resolves on ``"auto"`` for this model's
    prefill of ``tokens`` (the same cached instance the prefill runs)."""
    from repro_torch import compile_plan
    from repro_torch.models.ssm import _smooth_result, smooth_env

    x = model.embed[tokens]
    B, S, C = x.shape
    res = _smooth_result(S, B * C, cfg.race_smooth_radius)
    return compile_plan(res.plan, smooth_env(x, model.smooth_taps,
                                             cfg.race_smooth_radius))


def lm_weights(model) -> tuple:
    """(parameters in the layers, bytes every decode step reads: every
    weight but the embedding table, of which one row a token)."""
    layers = sum(p.numel() for part in (model.prelude, model.units,
                                        model.trailing)
                 for p in part.parameters())
    table = model.embed.numel() * model.embed.element_size()
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    return layers, total - table


def device_split(label, fn, torch, top: int = 6) -> None:
    """One call of ``fn`` under ``torch.profiler``: the card's busy time
    (the kernels' summed device time) against the call's wall time (which
    the profiler itself lengthens), so the idle share, and the ``top``
    operators by the device time of the kernels they launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    if not busy_ms:
        print(f"{label} profile: no device time in the trace (not "
              f"measured); wall {wall_ms:.3f} ms", flush=True)
        return
    print(f"{label} profile: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms in {len(kernels)} kernels, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; top operators by device ms: "
          + "; ".join(f"{e.key} x{e.count} {e.self_device_time_total / 1e3:.3f}"
                      for e in ops[:top] if e.self_device_time_total > 0),
          flush=True)


def lm_main(torch) -> tuple:
    """lm:qwen2-7b: the mixer on K1, then prefill and decode at full
    width; returns (the mixer's kernel-line entry, prefill ms)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import (ExecConfig, init_caches, init_params,
                                    prefill_logits)
    from repro_torch.models.steps import make_decode_step

    cfg = get_config(LM_ARCH).scaled(race_smooth_radius=LM_RADIUS)
    full = get_config(LM_ARCH)
    assert dataclasses.replace(cfg, race_smooth_radius=0) == full
    t0 = time.time()
    gen = torch.Generator(DEVICE).manual_seed(0)
    model = init_params(cfg, generator=gen, device=DEVICE)
    with torch.no_grad():
        model.smooth_taps.copy_(0.5 * torch.randn(
            LM_RADIUS + 1, generator=gen, device=DEVICE))
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in model.parameters())
    layers, step_bytes = lm_weights(model)
    print(f"lm:qwen2-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, {n_all} parameters "
          f"({n_all * 2 / 1e9:.2f} GB), taps "
          f"{[round(float(t), 4) for t in model.smooth_taps]}, init "
          f"{time.time() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (LM_BATCH, LM_PROMPT)),
                             device=DEVICE)
    batch = {"tokens": tokens}
    exec_cfg = ExecConfig()

    entry, k1_ms = lm_mixer_check(model.embed[tokens], model.smooth_taps,
                                  torch)
    ex = mixer_executor(model, cfg, tokens)
    if ex.backend != "hopper":
        raise SystemExit(f"lm: the mixer selected {ex.backend}: "
                         f"{ex.selection.capability.explain()}")
    # the main path: one prefill, K1's launches counted from 0
    ex.spec.launches = 0
    logits = prefill_logits(model, cfg, exec_cfg, batch)
    torch.cuda.synchronize()
    entry["launches"] = launches = ex.kernel_launches
    if launches != 1:
        raise SystemExit(f"lm: the prefill launched K1 {launches} times, "
                         f"not once")
    os.environ["RACE_BACKEND"] = "torch"
    try:
        plain = prefill_logits(model, cfg, exec_cfg, batch)
    finally:
        del os.environ["RACE_BACKEND"]
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    diff = float((logits - plain).abs().max())
    same = bool((logits.argmax(-1) == plain.argmax(-1)).all())
    print(f"lm prefill: logits {tuple(logits.shape)} finite "
          f"{bool(torch.isfinite(logits).all())}, K1 launches {launches}; "
          f"vs the torch mixer: argmax equal on every row {same}, max |diff| "
          f"{diff:.3e} (<= {LM_LOGITS_TOL:.0e} x {scale:.3e})", flush=True)
    if not (same and diff <= LM_LOGITS_TOL * scale
            and bool(torch.isfinite(logits).all())):
        raise SystemExit("lm prefill: K1's prefill disagrees with the "
                         "torch mixer's")
    prefill_ms = _time_ms(lambda: prefill_logits(model, cfg, exec_cfg,
                                                 batch), torch)
    tok = LM_BATCH * LM_PROMPT
    attn = (cfg.num_layers * 2 * LM_BATCH * cfg.n_heads * cfg.d_head
            * LM_PROMPT * (LM_PROMPT + 1))
    ops = 2 * layers * tok + attn + 2 * LM_BATCH * cfg.d_model * cfg.vocab
    pre_bound, pre_by = bound_of(sum(p.numel() * p.element_size()
                                     for p in model.parameters()), ops,
                                 PEAK_BF16_TC_FLOPS)
    print(f"lm prefill: {prefill_ms:.4f} ms, {tok / prefill_ms * 1e3:.1f} "
          f"tok/s; bound {pre_bound:.4f} ms ({pre_by}: {ops:.4e} flop at "
          f"{PEAK_BF16_TC_FLOPS:.3e}/s), share of bound "
          f"{pre_bound / prefill_ms:.3f}; K1 {k1_ms:.4f} ms = "
          f"{k1_ms / prefill_ms:.4f} of the prefill", flush=True)

    device_split("lm prefill", lambda: prefill_logits(
        model, cfg, exec_cfg, batch), torch)

    # decode: the prompt teacher-forced into the caches, then greedy steps
    max_len = LM_PROMPT + LM_GEN
    caches = init_caches(cfg, LM_BATCH, max_len, device=DEVICE)
    step = make_decode_step(cfg, exec_cfg, max_len)
    t0 = time.time()
    for t in range(LM_PROMPT):
        out, caches = step(model, caches, tokens[:, t:t + 1], t)
    torch.cuda.synchronize()
    forced_s = time.time() - t0
    nxt = out.argmax(-1)[:, None]
    lat = []
    for t in range(LM_PROMPT, max_len):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, caches = step(model, caches, nxt, t)
        nxt = out.argmax(-1)[:, None]
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end) * 1e3)
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("lm decode: non-finite logits")
    # one more step at the last position (it rewrites that slot in place)
    device_split("lm decode step", lambda: step(model, caches, nxt,
                                                max_len - 1), torch)
    p50, p90 = _pct(lat, 0.50), _pct(lat, 0.90)
    kv = sum(v.numel() * v.element_size() for c in caches["units"]
             for v in c.values())
    dec_bound, dec_by = bound_of(step_bytes + kv, 2 * layers * LM_BATCH,
                                 PEAK_BF16_TC_FLOPS)
    print(f"lm decode: teacher-forced {LM_PROMPT} steps in {forced_s:.2f} "
          f"s; {LM_GEN} greedy steps p50 {p50:.1f} us, p90 {p90:.1f} us, "
          f"{LM_BATCH / p50 * 1e6:.1f} tok/s at p50; bound {dec_bound:.4f} "
          f"ms ({dec_by}: {step_bytes + kv} B), share of bound "
          f"{dec_bound * 1e3 / p50:.3f}", flush=True)
    del model, caches, logits, plain
    torch.cuda.empty_cache()
    return entry, prefill_ms


def _decode_parity(model, cfg, exec_cfg, tokens, torch) -> tuple:
    """(prefill's last-position logits, teacher-forced decode's)."""
    from repro_torch.models import decode_step, forward_hidden, init_caches
    from repro_torch.models.common import mm

    B, S = tokens.shape
    with torch.no_grad():
        h = forward_hidden(model, cfg, exec_cfg, {"tokens": tokens})
        want = mm(h[:, -1], model.head).float()
    caches = init_caches(cfg, B, S, device=DEVICE)
    for t in range(S):
        got, caches = decode_step(model, caches, cfg, exec_cfg,
                                  tokens[:, t:t + 1], t, max_len=S)
    return want, got


def lm_parity(torch) -> None:
    """lm:parity: full width at float32, 4 layers, zero taps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import ExecConfig, init_params

    cfg = get_config(LM_ARCH).scaled(num_layers=LM_PARITY_LAYERS,
                                     dtype="float32",
                                     race_smooth_radius=LM_RADIUS)
    model = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(1),
                        device=DEVICE)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_PARITY_BATCH, LM_PARITY_PROMPT)), device=DEVICE)
    want, got = _decode_parity(model, cfg, ExecConfig(), tokens, torch)
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    print(f"lm:parity ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"float32, zero taps, {LM_PARITY_PROMPT} tokens): decode vs "
          f"prefill max |diff| {diff:.3e} (<= 1e-3 x {scale:.3e})",
          flush=True)
    if not diff <= 1e-3 * scale:
        raise SystemExit("lm:parity: teacher-forced decode does not "
                         "reproduce the prefill")
    del model
    torch.cuda.empty_cache()


def lm_families(torch) -> None:
    """lm:families: every architecture's reduced config on the card."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import (ExecConfig, init_caches, init_params,
                                    prefill_logits)
    from repro_torch.models.steps import make_decode_step

    B, S = LM_FAMILY_SHAPE
    exec_cfg = ExecConfig(attn_chunk_q=8, attn_chunk_k=8, ssm_chunk=8)
    failures = []
    for arch in ARCHS + [LM_ARCH + "+race_smooth"]:
        name = arch.split("+")[0]
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        if cfg.kind == "moe":
            cfg = dataclasses.replace(cfg,
                                      moe_capacity=float(cfg.moe_experts))
        if "+" in arch:
            cfg = dataclasses.replace(cfg, race_smooth_radius=LM_RADIUS)
        model = init_params(cfg, generator=torch.Generator(
            DEVICE).manual_seed(2), device=DEVICE)
        rng = np.random.default_rng(2)
        batch = {}
        if cfg.input_embed_dim:
            batch["embeds"] = torch.as_tensor(rng.standard_normal(
                (B, S, cfg.input_embed_dim)), dtype=torch.float32,
                device=DEVICE)
        else:
            batch["tokens"] = torch.as_tensor(rng.integers(
                0, cfg.vocab, (B, S)), device=DEVICE)
        if cfg.kind == "vlm":
            batch["vision"] = torch.as_tensor(rng.standard_normal(
                (B, cfg.vision_tokens, cfg.vision_dim)), dtype=torch.float32,
                device=DEVICE)
        ex = None
        if cfg.race_smooth_radius:
            with torch.no_grad():
                model.smooth_taps.copy_(torch.tensor([0.3, -0.2, 0.1]))
            ex = mixer_executor(model, cfg, batch["tokens"])
            ex.spec.launches = 0
        logits = prefill_logits(model, cfg, exec_cfg, batch)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(logits).all()) and tuple(
            logits.shape) == (B, cfg.vocab)
        line = f"lm:families {arch}: prefill {tuple(logits.shape)} finite {ok}"
        if ex is not None:
            line += f", K1 launches {ex.kernel_launches} ({ex.backend})"
            ok = ok and ex.backend == "hopper" and ex.kernel_launches == 1
        if cfg.supports_decode():
            caches = init_caches(cfg, B, S, device=DEVICE)
            step = make_decode_step(cfg, exec_cfg, S)
            tok = batch["tokens"][:, :1]
            for t in range(LM_FAMILY_STEPS):
                out, caches = step(model, caches, tok, t)
                tok = out.argmax(-1)[:, None]
                ok = ok and bool(torch.isfinite(out).all())
            line += f"; {LM_FAMILY_STEPS} decode steps finite {ok}"
            if cfg.kind != "vlm" and not cfg.race_smooth_radius:
                want, got = _decode_parity(model, cfg, exec_cfg,
                                           batch["tokens"], torch)
                # the reference's tests/test_arch_smoke.py tolerance
                close = bool(torch.allclose(got, want, rtol=2e-3,
                                            atol=2e-4))
                line += (f"; decode vs prefill max |diff| "
                         f"{float((got - want).abs().max()):.3e} "
                         f"(rtol 2e-3, atol 2e-4) {close}")
                ok = ok and close
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            failures.append(line)
        del model
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("lm:families failed:\n" + "\n".join(failures))


def _train_arg(flag: str, argv=None) -> int:
    argv = argv or TRAIN_ARGV
    return int(argv[argv.index(flag) + 1])


def train_mixer_cells() -> list:
    """(label, S, channels) of the mixers phase 16 trains through."""
    from repro_torch.configs import get_config

    full = get_config(LM_ARCH)
    return [("qwen2-7b", _train_arg("--seq"),
             _train_arg("--batch") * full.d_model),
            ("resume", TRAIN_RESUME["seq"],
             TRAIN_RESUME["batch"] * full.reduced().d_model)]


def mixer_sources(S: int, C: int, adjoints: bool) -> list:
    """The K1 sources of one mixer shape (float32 streams): its forward
    and, with ``adjoints``, every adjoint plan the probe admits: each
    spec's (the taps': the summed kernel, timed beside their group) and
    the taps' group's, which the backward runs."""
    from repro_torch.core.adjoint import adjoint_build, adjoint_env_shapes
    from repro_torch.core.backend import select_backend
    from repro_torch.core.codegen import required_shapes
    from repro_torch.lowering.emit import specialize_stencil
    from repro_torch.models.ssm import _smooth_result

    res = _smooth_result(S, C, LM_RADIUS)
    shapes = required_shapes(res.program)
    out = [specialize_stencil(res.plan, shapes, {
        k: "float32" for k in shapes}).source]
    build = adjoint_build(res.program)
    group = build.scalar_group([s.input for s in build.specs])
    for unit in build.specs + [group] if adjoints else ():
        plan = unit.result().plan
        if select_backend(plan, "auto", ["float32"]).backend == "hopper":
            adj = adjoint_env_shapes(unit, res.program, shapes)
            sp = specialize_stencil(plan, adj, {k: "float32" for k in adj})
            out.append(sp.source_for(1, unit.scalar))
    return out


def train_sources() -> list:
    """The K1 sources of phase 16's mixers, forward and adjoints, built in
    phase 2."""
    return [src for _, S, C in train_mixer_cells()
            for src in mixer_sources(S, C, True)]


def train_mixer_executors(model, cfg, tokens, torch):
    """The mixer's env and executors at this batch, as a train step resolves
    them on ``"auto"``: (env, forward executor, [(spec, adjoint env,
    executor), ...])."""
    from repro_torch import compile_plan
    from repro_torch.models.ssm import _smooth_result, smooth_env

    with torch.no_grad():
        x = model.embed[tokens]
        env = {k: v.clone() for k, v in smooth_env(
            x, model.smooth_taps, cfg.race_smooth_radius).items()}
    B, S, C = x.shape
    res = _smooth_result(S, B * C, cfg.race_smooth_radius)
    return (env, compile_plan(res.plan, env),
            adjoint_executors(res.program, env, ones_cotangent(env, torch)))


def ones_cotangent(env, torch) -> dict:
    """The mixer's output cotangent that phases 16 and 18 assemble their
    adjoint envs with: ones."""
    return {"sy": torch.ones_like(env["sy"])}


def train_mixer_grads(x, ex, adj, torch) -> tuple:
    """The mixer's gradients with respect to ``sx`` (through ``x``, float32)
    and its taps, on K1 (``"auto"``: the forward ``ex`` and each adjoint
    run of ``adj`` must launch once, each tap's gradient bit for bit its
    group's, :func:`group_gate`) against the whole mixer on ``"torch"``:
    (rel err, max abs err)."""
    from repro_torch.models.ssm import race_smooth
    from repro_torch.testing import rel_err

    g = torch.Generator(DEVICE).manual_seed(3)
    taps = (0.5 * torch.randn(LM_RADIUS + 1, generator=g, device=DEVICE)
            ).requires_grad_()
    x = x.detach().float().requires_grad_()

    def grads():
        y = race_smooth(x, taps, radius=LM_RADIUS)
        w = cos_weights({"y": y}, torch)["y"]
        return dict(zip(("sx", "taps"), torch.autograd.grad(
            (y * w).sum(), (x, taps))))

    execs = [ex] + [e for _, _, e in adj]
    before = [e.kernel_launches for e in execs]
    with captured_sums(adj) as seen:
        k1 = grads()
    torch.cuda.synchronize()
    if [e.kernel_launches - n for e, n in zip(execs, before)] != [1] * len(
            execs):
        raise SystemExit("lm:train: the mixer's forward and adjoints did not "
                         "each launch K1 once")
    names = [f"sw{d}" for d in range(LM_RADIUS + 1)]
    bad = group_gate(adj, seen, {k: taps[d].detach().float()
                                 for d, k in enumerate(names)},
                     {k: k1["taps"][d] for d, k in enumerate(names)})
    if bad:
        raise SystemExit(f"lm:train: {'; '.join(bad)}")
    os.environ["RACE_BACKEND"] = "torch"
    try:
        plain = grads()
    finally:
        del os.environ["RACE_BACKEND"]
    torch.cuda.synchronize()
    return rel_err(k1, plain), max(float((k1[k] - plain[k]).abs().max())
                                   for k in k1)


def train_bound(model, opt_state, cfg, tokens: int) -> tuple:
    """(bound ms, by, flop, bytes, matrix weights) of one train step: 6 flop per matrix
    weight (every 2-D block weight and the head; the embedding is a
    gather) and token plus the causal attention's products forward and
    backward (remat's recompute not counted), at the bf16 tensor-core
    rate; the bytes AdamW must move: parameters and moments read and
    written, gradients read."""
    from repro_torch.tree import as_array, leaves

    blocks = [p for part in (model.prelude, model.units, model.trailing)
              for p in part.parameters() if p.dim() == 2]
    matrix = sum(p.numel() for p in blocks) + model.head.numel()
    B, S = _train_arg("--batch"), _train_arg("--seq")
    attn = 3 * cfg.num_layers * 2 * B * cfg.n_heads * cfg.d_head * S * (S + 1)
    flop = 6 * matrix * tokens + attn
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sbytes = sum(as_array(t).numel() * as_array(t).element_size()
                 for t in leaves(opt_state["mu"]))
    nbytes = 3 * pbytes + 2 * sbytes
    ms, by = bound_of(nbytes, flop, PEAK_BF16_TC_FLOPS)
    return ms, by, flop, nbytes, matrix


def train_main(root, torch) -> list:
    """lm:train:qwen2-7b; returns the kernel-line entries of the mixer's
    forward and adjoints."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.testing import default_tolerances

    ckpt = root / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = train.parser().parse_args(TRAIN_ARGV + ["--ckpt-dir", str(ckpt)])
    t0 = time.time()
    cfg, trainer = train.setup(args)
    model = trainer.params
    trainer.cfg.log_fn = lambda *a: print(*a, flush=True)
    trainer.cfg.log_every = 1
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in model.parameters())
    free = shutil.disk_usage(root).free
    print(f"lm:train:qwen2-7b: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, {n_all} parameters "
          f"(n_params() {cfg.n_params()}), race_smooth_radius "
          f"{cfg.race_smooth_radius}; batch {args.batch} x {args.seq}, "
          f"{args.steps} steps, lr {args.lr}; setup {time.time() - t0:.1f} "
          f"s; disk free {free / 1e9:.1f} GB", flush=True)
    batch0 = trainer.pipe.batch_at(0)
    tokens = torch.as_tensor(batch0["tokens"], device=DEVICE)
    env, ex, adj = train_mixer_executors(model, cfg, tokens, torch)
    off = [f"{unit_label(u)}: {e.backend} "
           f"{[r.code for r in e.selection.capability.reasons]}"
           for u, _, e in adj if e.backend != "hopper"]
    if ex.backend != "hopper" or off or not adj:
        raise SystemExit(f"lm:train: mixer off K1: forward {ex.backend}, "
                         f"adjoints {off or len(adj)}")
    execs = [ex] + [e for _, _, e in adj]

    times, marks = [], {}
    inner = trainer.train_step

    def timed(p, o, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(p, o, b)
        torch.cuda.synchronize()
        marks["end"] = time.perf_counter()
        times.append((marks["end"] - t) * 1e3)
        return out

    trainer.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    for e in execs:
        e.spec.launches = 0
    # the main path: launch.train's Trainer, K1's counts from 0
    out = trainer.run()
    t_end = time.perf_counter()
    launches = [e.kernel_launches for e in execs]
    peak = torch.cuda.max_memory_allocated()
    steps = out["step"]
    ckpt_dir = ckpt / f"step_{steps:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    ckpt_s = t_end - marks["end"]
    losses = out["losses"]
    print(f"lm:train losses {[round(x, 4) for x in losses]}, restarts "
          f"{out['restarts']}; K1 launches: forward {launches[0]}, adjoints "
          f"{dict(zip((unit_label(u) for u, _, _ in adj), launches[1:]))} "
          f"over {len(losses)} steps; final checkpoint {ckpt_bytes} B in "
          f"{ckpt_s:.2f} s (snapshot, write, fsync; phase 17 re-shards it)",
          flush=True)
    if (len(losses) != args.steps or not all(math.isfinite(x)
                                             for x in losses)
            or any(n != len(losses) for n in launches)):
        raise SystemExit("lm:train: a loss is not finite, or K1 did not "
                         "launch once per step on the forward and on every "
                         "adjoint run")
    step_ms = statistics.median(times[1:])
    tok = args.batch * args.seq
    bound_ms, by, flop, nbytes, matrix = train_bound(
        model, trainer.opt_state, cfg, tok)
    print(f"lm:train step on {_nvidia_smi()}: {step_ms:.4f} ms (median of "
          f"steps 2-{len(times)}; each {[round(t, 1) for t in times]}), "
          f"{tok / step_ms * 1e3:.1f} tok/s; peak memory {peak / 1e9:.2f} GB;"
          f" bound {bound_ms:.4f} ms ({by}: {flop:.4e} flop for {matrix} "
          f"matrix weights at {PEAK_BF16_TC_FLOPS:.3e}/s, {nbytes} B of "
          f"AdamW at {HBM_BYTES_PER_S:.3e}/s), share of bound "
          f"{bound_ms / step_ms:.3f}", flush=True)

    # the mixer's gradients on K1 against "torch" at the step's shape
    x = model.embed[tokens]
    e_grad, grad_abs = train_mixer_grads(x, ex, adj, torch)
    tol = default_tolerances("float32")["grad"]
    print(f"lm:train mixer grads (sx, taps) K1 vs torch {e_grad:.2e} (<= "
          f"{tol:.0e}), max_abs_err {grad_abs:.3e}", flush=True)
    if not e_grad <= tol:
        raise SystemExit("lm:train: the mixer's gradients on K1 disagree "
                         "with torch's")

    entries, fwd_ms, adj_ms = k1_mixer_lines(
        "lm:train", "train", ex, env, adj, launches[0], launches[1:],
        grad_abs, torch)
    print(f"lm:train K1 = {(fwd_ms + adj_ms) / step_ms:.4f} of the step",
          flush=True)

    device_split("lm:train step", lambda: trainer.train_step(
        model, trainer.opt_state, batch0), torch)
    del trainer, model, env, ex, adj, execs, x
    torch.cuda.empty_cache()
    return entries, step_ms


def k1_mixer_lines(label, tag, ex, env, adj, fwd_launches, adj_launches,
                   grad_abs, torch, split_sx: bool = False) -> tuple:
    """The mixer's forward executor ``ex`` at ``env`` on K1 against
    ``"torch"`` (within ``plan``), then it and every adjoint run's
    executor timed beside their plain versions, bounds and (forward) the
    library call; ``adj_launches`` per run of ``adj``.  Returns (the
    kernel-line entries, forward ms, summed adjoint ms): the forward and
    the adjoints summed, or with ``split_sx`` the ``sx`` adjoint (checked
    against and timed beside its library call,
    :func:`sx_adjoint_library_call`) and the tap adjoints' group apart
    (theirs: :func:`tap_adjoint_check`; each tap's own launch is timed
    beside it)."""
    from repro_torch import compile_plan
    from repro_torch.testing import default_tolerances, rel_err

    got = ex(env)
    ex_t = compile_plan(ex.plan, env, "torch")
    plain = ex_t(env)
    torch.cuda.synchronize()
    fwd_abs = float((got["sy"] - plain["sy"]).abs().max())
    if rel_err(got, plain) > default_tolerances("float32")["plan"]:
        raise SystemExit(f"{label}: K1's mixer forward disagrees with torch")
    del got, plain
    fwd_ms = _time_ms(lambda: ex(env), torch)
    fwd_plain = _time_ms(lambda: ex_t(env), torch)
    fwd_lib = _time_ms(mixer_library_call(env, LM_RADIUS, torch), torch)
    fb, fo = plan_work(ex.plan, env, 4)
    fwd_bound, fwd_by = bound_of(fb, fo, PEAK_FLOPS["float32"])
    groups = {}  # adjoint line -> ms, plain ms, bytes, ops, launches
    per_spec = []
    sx_lib = sw_lib = None
    sw = []
    for (unit, a, e), n in zip(adj, adj_launches, strict=True):
        key = "" if not split_sx else " sx" if unit.members[
            0].input == "sx" else " sw"
        g = groups.setdefault(key, [0.0, 0.0, 0, 0, 0])
        ms = _time_ms(adjoint_call(unit, e, a), torch)
        per_spec.append(f"{unit_label(unit)} {ms:.4f}")
        e_t = compile_plan(unit.result().plan, a, "torch")
        b_, o_ = plan_work(unit.result().plan, a, 4, unit.scalar)
        g[0] += ms
        g[1] += _time_ms(lambda: e_t(a), torch)
        g[2], g[3], g[4] = g[2] + b_, g[3] + o_, g[4] + n
        if key == " sx":
            lib = sx_adjoint_library_call(a, LM_RADIUS, torch)
            e_lib = rel_err(lib(), e(a))
            if e_lib > default_tolerances("float32")["baseline"]:
                raise SystemExit(f"{label}: conv1d and K1 disagree on the "
                                 f"sx adjoint ({e_lib:.2e})")
            sx_lib = _time_ms(lib, torch)
        elif key == " sw":
            sw.append((unit, a, e))
    if sw:  # the kernel line takes mv: cuDNN's conv1d is ~300x slower
        (grp,) = sw
        own = spec_executors(grp[0].members, env, ones_cotangent(env, torch))
        conv, launch, _, mv, launches, _ = tap_adjoint_check(
            label, grp, own, LM_RADIUS, torch)
        sw_lib = _time_ms(mv, torch)
        print(f"{label} tap adjoints one call at a time: the group (1 "
              f"launch) {_time_ms(launch, torch):.4f} ms, each tap's own "
              f"(3 launches) {_time_ms(launches, torch):.4f} ms; library "
              f"calls: mv {sw_lib:.4f} ms, conv1d "
              f"{_time_ms(conv, torch):.4f} ms", flush=True)
        del own
    adj_ms = sum(g[0] for g in groups.values())
    common = dict(route="cuda", source="src/repro_torch/lowering/emit.py",
                  replaces="src/repro/lowering/emit.py:273")
    entries = [dict(name=f"race_stencil[race_smooth {tag}]",
                    launches=fwd_launches, max_abs_err=fwd_abs, ms=fwd_ms,
                    plain_ms=fwd_plain, bound_ms=fwd_bound, bound_by=fwd_by,
                    library_ms=fwd_lib, **common)]
    parts = []
    for key, (ms, plain, b_, o_, n) in groups.items():
        bound, by = bound_of(b_, o_, PEAK_FLOPS["float32"])
        lib = {" sx": sx_lib, " sw": sw_lib}.get(key)
        parts.append(f"adjoint{key} {ms:.4f} ms (torch {plain:.4f}, "
                     f"bound {bound:.4f} {by}, library "
                     f"{'none' if lib is None else f'{lib:.4f}'})")
        entries.append(dict(name=f"race_stencil[race_smooth {tag} "
                                 f"adjoint{key}]",
                            launches=n, max_abs_err=grad_abs, ms=ms,
                            plain_ms=plain, bound_ms=bound, bound_by=by,
                            library_ms=lib, **common))
    print(f"{label} K1 per call, sx {tuple(env['sx'].shape)}: forward "
          f"{fwd_ms:.4f} ms (torch {fwd_plain:.4f}, conv1d {fwd_lib:.4f}, "
          f"bound {fwd_bound:.4f} {fwd_by}); {'; '.join(parts)}; "
          f"{len(adj)} adjoint launches a step: {', '.join(per_spec)}",
          flush=True)
    return entries, fwd_ms, adj_ms


def elastic_check(root, torch) -> None:
    """Phase 17, elastic: phase 16's final lm:train:qwen2-7b checkpoint
    re-sharded onto a 2x2 (data, model) mesh of cuda:0, gathered back leaf
    by leaf and compared with the checkpoint's arrays bit for bit; then the
    checkpoint is deleted."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    from repro_torch.launch.specs import meta_params
    from repro_torch.models.sharding import gather
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.elastic import reshard_checkpoint
    from repro_torch.tree import leaves_with_paths, path_key

    ckpt = root / "build" / "train_ckpt"
    args = train.parser().parse_args(TRAIN_ARGV + ["--ckpt-dir", str(ckpt)])
    cfg = train.model_config(args)
    params = meta_params(cfg).param_tree()
    like = {"params": params, "opt": adamw_init(params,
                                                AdamWConfig(lr=args.lr))}
    step = latest_step(ckpt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, got_step, mesh = reshard_checkpoint(
        ckpt, like, cfg, ELASTIC_MESH, ("data", "model"),
        devices=[DEVICE] * int(np.prod(ELASTIC_MESH)))
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    placed = list(leaves_with_paths(state))
    shard_bytes = [s.numel() * s.element_size()
                   for _, p in placed for s in p.shards.flat]
    held = torch.cuda.memory_allocated() - mem0
    manifest = json.loads((ckpt / f"step_{step:08d}" / "manifest.json")
                          .read_text())
    t0 = time.perf_counter()
    unequal = []
    for path, p in placed:
        meta = manifest["arrays"][path_key(path)]
        want = np.load(ckpt / f"step_{step:08d}" / meta["file"],
                       mmap_mode="r")
        back = gather(p).cpu()
        if back.dtype == torch.bfloat16:
            back = back.view(torch.int16)
        if not np.array_equal(back.numpy().view(want.dtype), want):
            unequal.append(path_key(path))
    gather_s = time.perf_counter() - t0
    print(f"elastic: lm:train:qwen2-7b step {got_step} re-sharded onto "
          f"{mesh} in {reshard_s:.2f} s ({len(placed)} leaves, "
          f"{len(shard_bytes)} shards, {sum(shard_bytes)} B on the card, "
          f"{held} B allocated; largest shard {max(shard_bytes)} B); "
          f"gathered and compared in {gather_s:.2f} s: "
          f"{'bit-equal' if not unequal else f'{len(unequal)} leaves differ'}"
          f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del state, placed
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    if got_step != step or unequal:
        raise SystemExit(f"elastic: the re-sharded checkpoint differs from "
                         f"step {step}'s: {unequal[:5]}")


def grad_sync_check(torch) -> None:
    """Phase 17, grad sync: four members of a ``data`` axis on cuda:0, each
    with the gradient of one qwen2-7b layer unit (full width) from its own
    pipeline batch; ``compressed_pmean_tree`` twice, the second round fed
    the first's error."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.models import ExecConfig, init_params, make_loss_fn
    from repro_torch.runtime.grad_sync import (compressed_pmean_tree,
                                               wire_bytes)

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=1)
    model = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(0),
                        device=DEVICE, trainable=True)
    model.requires_grad_(False)
    unit = model.units[0].requires_grad_(True)
    names = [n for n, _ in unit.named_parameters()]
    exec_cfg = ExecConfig(attn_chunk_q=128, attn_chunk_k=256, ssm_chunk=64,
                          loss_chunk=128)
    loss_fn = make_loss_fn(cfg, exec_cfg)
    B, S = GRAD_SYNC_BATCH
    pipe = ShardedTokenPipeline(DataConfig(seq_len=S, global_batch=B,
                                           vocab=cfg.vocab))
    grads = []
    for i in range(GRAD_SYNC_MEMBERS):  # each member's own batch
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in pipe.batch_at(i).items()}
        gs = torch.autograd.grad(loss_fn(model, batch),
                                 list(unit.parameters()))
        grads.append({n: g.float() for n, g in zip(names, gs)})
        del batch, gs
    del model, unit
    torch.cuda.empty_cache()
    n_params = sum(g.numel() for g in grads[0].values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m1, e1 = compressed_pmean_tree(grads)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    m2, e2 = compressed_pmean_tree(grads, e1)
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    rel, agree, telescope = 0.0, True, 0.0
    for n in names:
        exact = sum(g[n] for g in grads) / len(grads)
        scale = float(exact.abs().max())
        rel = max(rel, float((m1[0][n] - exact).abs().max()) / scale)
        agree &= all(torch.equal(m[n], m1[0][n]) for m in m1[1:])
        agree &= all(torch.equal(m[n], m2[0][n]) for m in m2[1:])
        # error feedback: deq1 + deq2 = 2 g - e2 per member, so
        # m1 + m2 = 2 exact - mean(e2) up to float32 rounding
        carried = 2 * exact - sum(e[n] for e in e2) / len(e2)
        telescope = max(telescope, float((m1[0][n] + m2[0][n] - carried)
                                         .abs().max()) / scale)
    fed = any(not torch.equal(m1[0][n], m2[0][n]) for n in names)
    int8_b, f32_b = wire_bytes(grads)
    print(f"grad sync: {len(grads)} members of 'data' on {DEVICE}, one "
          f"qwen2-7b layer unit ({n_params} parameters, {len(names)} "
          f"leaves, float32 gradients of {B} x {S}-token batches): round 1 "
          f"{ms1:.2f} ms, round 2 (fed the carried error) {ms2:.2f} ms; "
          f"rel err vs the exact mean {rel:.3e} (< 0.02); members agree "
          f"{agree}; m1 + m2 vs 2 exact - mean(e2) {telescope:.2e}; "
          f"per member on the wire {int8_b} B int8 + scales against "
          f"{f32_b} B float32 ({f32_b / int8_b:.2f}x); peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    if not (rel < 0.02 and agree and fed and telescope < 1e-5):
        raise SystemExit("grad sync: the compressed mean is off, the members "
                         "disagree, or the second round ignored the carried "
                         "error")


def train_resume(root, torch) -> None:
    """lm:train:resume: straight against checkpointed-and-resumed, bit for
    bit, on the card."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.executor import executor_cache
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.models import ExecConfig, init_params, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import as_array, leaves

    r = TRAIN_RESUME
    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(), dtype="float32",
                              race_smooth_radius=LM_RADIUS)
    exec_cfg = ExecConfig(attn_chunk_q=min(128, r["seq"]),
                          attn_chunk_k=min(256, r["seq"]),
                          ssm_chunk=min(64, r["seq"]),
                          loss_chunk=min(128, r["seq"]))
    opt_cfg = AdamWConfig(lr=r["lr"])
    step = make_train_step(cfg, opt_cfg, exec_cfg, total_steps=r["steps"],
                           warmup=1)
    pipe = ShardedTokenPipeline(DataConfig(seq_len=r["seq"],
                                           global_batch=r["batch"],
                                           vocab=cfg.vocab))
    base = root / "build" / "train_resume"
    shutil.rmtree(base, ignore_errors=True)

    def run(total, name):
        model = init_params(cfg, generator=torch.Generator(DEVICE)
                            .manual_seed(0), device=DEVICE, trainable=True)
        tr = Trainer(TrainerConfig(total_steps=total, ckpt_dir=str(base / name),
                                   ckpt_every=r["every"],
                                   log_fn=lambda *a: None),
                     step, pipe, model, adamw_init(model, opt_cfg))
        return tr, tr.run()

    t0 = time.time()
    executor_cache().clear()
    a, out_a = run(r["steps"], "straight")
    run(r["every"], "resumed")
    b, out_b = run(r["steps"], "resumed")
    torch.cuda.synchronize()
    shutil.rmtree(base, ignore_errors=True)
    same_p = all(torch.equal(as_array(x).detach(), as_array(y).detach())
                 for x, y in zip(leaves(a.params.param_tree()),
                                 leaves(b.params.param_tree())))
    same_o = all(torch.equal(as_array(x), as_array(y))
                 for x, y in zip(leaves(a.opt_state), leaves(b.opt_state)))
    la = out_a["losses"]
    on_k1 = {e.backend for e in executor_cache().executors()}
    print(f"lm:train:resume ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"float32, batch {r['batch']} x {r['seq']}): straight losses "
          f"{[round(x, 4) for x in la]}, resumed {[round(x, 4) for x in out_b['losses']]}"
          f"; parameters bit-equal {same_p}, optimizer state bit-equal "
          f"{same_o}; mixer executors {sorted(on_k1)}; "
          f"{time.time() - t0:.1f} s", flush=True)
    if not (same_p and same_o and la[-1] < la[0] and on_k1 == {"hopper"}
            and out_b["losses"] == la[r["every"]:]):
        raise SystemExit("lm:train:resume: the resumed run differs from the "
                         "straight one, the loss did not fall, or the mixer "
                         "ran off K1")


def mesh_devices() -> list:
    return [DEVICE] * (MESH[0] * MESH[1])


def mesh_mixer_cells() -> list:
    """(label, S, channels, adjoints) of every mixer phase 18 runs: a mesh
    position's (its row's examples and ``d_model / 2`` channels) in each
    cell, and the one-device runs each cell is compared with."""
    from repro_torch.configs import get_config

    rows, m = MESH
    out = []
    for label, argv in MESH_TRAIN_CELLS:
        D = get_config(argv[argv.index("--arch") + 1]).d_model
        B, S = _train_arg("--batch", argv), _train_arg("--seq", argv)
        out += [(f"train {label}", S, B // rows * D // m, True),
                (f"train {label}, one device", S, B * D, True)]
    for label, arch, _ in MESH_RECURRENT:
        D = get_config(arch).d_model
        out += [(f"prefill {label}", LM_PROMPT, LM_BATCH // rows * D // m,
                 False),
                (f"prefill {label}, one device", LM_PROMPT, LM_BATCH * D,
                 False)]
    D = get_config(LM_ARCH).d_model
    d_red = get_config(LM_ARCH).reduced().d_model
    return out + [("prefill qwen2-7b", LM_PROMPT, LM_BATCH // rows * D // m,
                   False),
                  ("parity", LM_PARITY_PROMPT,
                   LM_PARITY_BATCH // rows * D // m, False),
                  ("cli", 64, 4 // rows * d_red // m, True)]


def mesh_sources() -> list:
    """The K1 sources of phase 18's mixers, built in phase 2."""
    return [src for _, S, C, adj in mesh_mixer_cells()
            for src in mixer_sources(S, C, adj)]


def _mesh_obs_positions(obs) -> dict:
    """position -> ``spmd_mixer`` spans (one per mixer call)."""
    out = {}
    for r in obs.span_records():
        if r["name"] == "spmd_mixer":
            pos = r["labels"]["position"]
            out[pos] = out.get(pos, 0) + 1
    return out


def one_device_steps(trainer, n: int, torch) -> tuple:
    """``n`` steps of ``trainer``'s one-device train step on its pipeline's
    first batches: (the losses, the median ms of steps 2-n).  The trainer
    takes each step's state, so the old AdamW state is freed."""
    losses, times = [], []
    for i in range(n):
        b = trainer.pipe.batch_at(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.params, trainer.opt_state, m = trainer.train_step(
            trainer.params, trainer.opt_state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    return losses, statistics.median(times[1:])


def moe_buffer(cfg, args, mesh) -> tuple:
    """A mesh position's expert buffer (E, C / R, F / M) in a train step of
    ``args``' batch, by ``models/spmd``'s split of the dispatch."""
    from repro_torch.launch import train
    from repro_torch.models import spmd

    T = args.batch * args.seq
    n = spmd._moe_chunks(T, train.exec_config(args, mesh))
    C = max(8, int(T // n * cfg.moe_top_k * cfg.moe_capacity)
            // cfg.moe_experts)
    rows, m = MESH
    c0, c1 = spmd._even(C, rows, 0)
    f0, f1 = spmd._even(cfg.d_ff, m, 0)
    return cfg.moe_experts, c1 - c0, f1 - f0


def activation_vs_peak(label, cfg, shape, mesh, exec_cfg, base: int,
                       peak: int) -> None:
    """The dry run's activation term (``launch/dryrun.py:
    activation_parts``) at this cell's shapes, a position's times the
    mesh's positions (all on this one card), beside the measured peak less
    the bytes allocated just before the step (the cell's arguments:
    parameters, optimizer state, batch, and what earlier steps keep);
    printed with their ratio, not gated: the peak also holds gradients and
    the step's transients, which the term leaves out."""
    from repro_torch.launch import dryrun

    parts = dryrun.activation_parts(cfg, shape, mesh, exec_cfg)
    term = sum(parts.values()) * mesh.size
    meas = peak - base
    print(f"{label} activation term on {_nvidia_smi()}: formula "
          f"{term:.4e} B ({mesh.size} positions x "
          f"{ {k: float(f'{v:.4e}') for k, v in parts.items()} }) vs "
          f"measured peak - arguments {meas:.4e} B (peak {peak} B, "
          f"allocated before the step {base} B); measured / formula "
          f"{meas / term:.3f}", flush=True)


def mesh_train(root, label, argv, torch) -> list:
    """mesh:train:<label>: ``launch.train`` with ``argv`` on the 2x2 mesh
    (``--mesh 2x2 --devices cuda:0,...``, no checkpoint), against the same
    model's one-device steps from the same initialization and batches in
    this call, on the sequence-parallel residual (the default) and, for
    :data:`MESH_LAYOUT_CELLS`, again on the replicated one; returns the
    mixer's kernel-line entries (the default layout's)."""
    from repro_torch.launch import train

    import shutil

    ckpt = root / "build" / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)  # nothing to resume from
    t0 = time.time()
    rows, m = MESH
    args = train.parser().parse_args(argv + ["--ckpt-dir", str(ckpt)])
    cfg, one = train.setup(args)
    tokens = torch.as_tensor(one.pipe.batch_at(0)["tokens"], device=DEVICE)
    with torch.no_grad():
        x = one.params.embed[tokens[:args.batch // rows]][
            ..., :cfg.d_model // m].clone()  # position (0, 0)'s slice
    ones, single_ms = one_device_steps(one, args.steps, torch)
    del one
    layouts = [("sequence-parallel", [])]
    if label in MESH_LAYOUT_CELLS:
        layouts.append(("replicated", ["--no-seq-parallel"]))
    runs, entries = {}, []
    for layout, extra in layouts:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs[layout], ent = mesh_train_layout(
            root, label, layout, argv + extra, x, ones, single_ms, t0,
            torch, kernel_lines=not runs)
        entries += ent
    if len(runs) == 2:
        mesh_layouts(label, runs)
    del x
    torch.cuda.empty_cache()
    return entries


def mesh_train_layout(root, label, layout, argv, x, ones, single_ms, t0,
                      torch, kernel_lines: bool) -> tuple:
    """One layout's run of mesh:train:<label> against one device's losses
    ``ones`` (``single_ms`` a step): (its numbers, its kernel-line entries
    if ``kernel_lines``)."""
    from repro_torch import compile_plan, obs
    from repro_torch.launch import train
    from repro_torch.launch.hlo_analysis import collective_traffic
    from repro_torch.models import ShapeSpec, spmd
    from repro_torch.models.ssm import _smooth_result, smooth_env
    from repro_torch.testing import default_tolerances

    ckpt = root / "build" / "mesh_ckpt"
    tag = label if layout == "sequence-parallel" else f"{label}:{layout}"
    single = ones[0]
    args = train.parser().parse_args(
        argv + ["--mesh", "x".join(map(str, MESH)), "--devices",
                ",".join(mesh_devices()), "--ckpt-dir", str(ckpt)])
    cfg, trainer = train.setup(args)
    mp = trainer.params
    trainer.cfg.log_fn = lambda *a: print(*a, flush=True)
    trainer.cfg.log_every = 1
    # no checkpoint: phase 16 times one; tests/test_torch_mesh.py holds the
    # mesh's gathered checkpoint and its restore bit-equal
    trainer._save = lambda: None
    env = {k: v.clone() for k, v in smooth_env(
        x, mp.placed["smooth_taps"].shards[0, 0].detach(),
        LM_RADIUS).items()}
    B_r, S, C = x.shape
    res = _smooth_result(S, B_r * C, LM_RADIUS)
    ex = compile_plan(res.plan, env)
    adj = adjoint_executors(res.program, env, ones_cotangent(env, torch))
    off = [f"{unit_label(u)}: {e.backend}" for u, _, e in adj
           if e.backend != "hopper"]
    if ex.backend != "hopper" or off or not adj:
        raise SystemExit(f"mesh:train:{tag}: mixer off K1: forward "
                         f"{ex.backend}, adjoints {off or len(adj)}")
    execs = [ex] + [e for _, _, e in adj]
    ec = train.exec_config(args, mp.mesh)
    seq = spmd.seq_layout(cfg, ec, mp.layout.M, args.seq)
    n_all = sum(p.numel() for p in mp.structure.parameters())
    print(f"mesh:train:{tag}: {mp.mesh}, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.dtype}, {n_all} parameters, batch "
          f"{args.batch} x {args.seq} ({B_r} a row), residual {layout} "
          f"(seq_parallel={ec.seq_parallel}, sequence-split {seq}), "
          f"position (0, 0)'s mixer sx {tuple(env['sx'].shape)}; one "
          f"device's step-1 loss {single:.6f}, step {single_ms:.4f} ms "
          f"(median of steps 2-{len(ones)}), losses "
          f"{[round(v, 4) for v in ones]}; setup {time.time() - t0:.1f} s",
          flush=True)
    if seq != (layout == "sequence-parallel"):
        raise SystemExit(f"mesh:train:{tag}: the step does not take the "
                         f"{layout} layout")
    times = []
    inner = trainer.train_step

    def timed(p, o, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(p, o, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.train_step = timed
    for e in execs:
        e.spec.launches = 0
    obs.reset()
    obs.configure(enabled=True)
    base = torch.cuda.memory_allocated()
    try:
        out = trainer.run()  # the main path: K1's counts from 0
        spans = _mesh_obs_positions(obs)
    finally:
        obs.reset()
    launches = [e.kernel_launches for e in execs]
    peak = torch.cuda.max_memory_allocated()
    activation_vs_peak(f"mesh:train:{tag}", cfg, ShapeSpec(
        "mesh_train", args.seq, args.batch, "train"), mp.mesh, ec, base,
        peak)
    losses = out["losses"]
    n = len(losses)
    npos = len(mp.layout.positions)
    log = mp.last_log
    by_kind = log.bytes_by_kind()
    traffic = collective_traffic(log, npos)
    step_ms = statistics.median(times[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ones)]
    print(f"mesh:train:{tag} losses {[round(v, 4) for v in losses]}; step "
          f"1 {losses[0]:.6f} vs one device {single:.6f} (rel "
          f"{rel[0]:.2e} <= {MESH_LOSS_TOL:.0e}), every step's rel "
          f"{[float(f'{r:.2e}') for r in rel]}; K1 launches: forward "
          f"{launches[0]}, "
          f"adjoints "
          f"{dict(zip((unit_label(u) for u, _, _ in adj), launches[1:]))}"
          f" over {n} steps on {npos} positions; mixer calls per position "
          f"{spans}", flush=True)
    ok = (n == args.steps == len(ones)
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0]
          and max(rel) <= MESH_LOSS_TOL
          and all(k == n * npos for k in launches)
          and len(spans) == npos and set(spans.values()) == {n})
    if not ok:
        raise SystemExit(f"mesh:train:{tag}: a loss is not finite, did not "
                         f"fall or is off one device's step's, or K1 did "
                         f"not run once a step on every position, forward "
                         f"and adjoints")
    if cfg.moe_experts:
        E, Cr, Fm = moe_buffer(cfg, args, mp.mesh)
        nb = E * Cr * cfg.d_model * torch.empty((), dtype=getattr(
            torch, cfg.dtype)).element_size()
        sums = sum(e.kind == "all-reduce" and e.nbytes == nb
                   for e in log.entries)
        print(f"mesh:train:{tag} expert buffer a position (E, C/R, F/M) "
              f"= {(E, Cr, Fm)}; the experts' partial outputs (E, C/R, D) "
              f"summed over model {sums} times in the last step", flush=True)
        if not sums:
            raise SystemExit(f"mesh:train:{tag}: no expert output was "
                             f"summed over model: the dispatch did not split")
    saved = dict(mp.last_saved)
    print(f"mesh:train:{tag} step on {_nvidia_smi()}: {step_ms:.4f} ms "
          f"(median of steps 2-{len(times)}; each "
          f"{[round(t, 1) for t in times]}) against one device's "
          f"{single_ms:.4f} ms (this call); "
          f"{args.batch * args.seq / step_ms * 1e3:.1f} tok/s; peak memory "
          f"{peak / 1e9:.2f} GB ({peak} B); transfer bytes per step by kind "
          f"(every position's results, forward and backward) {by_kind}; "
          f"wire bytes a position (hlo_analysis' models) "
          f"{traffic['bytes']:.4e}; bytes the units' remat saved a position "
          f"in the last step (saved_tensors_hooks) {saved}", flush=True)
    run = dict(losses=losses, step_ms=step_ms, peak=peak, by_kind=by_kind,
               saved=saved, M=mp.layout.M)
    if not kernel_lines:
        del trainer, mp, env, ex, adj, execs
        return run, []
    e_grad, grad_abs = train_mixer_grads(x, ex, adj, torch)
    tol = default_tolerances("float32")["grad"]
    print(f"mesh:train:{tag} mixer grads (sx, taps) K1 vs torch "
          f"{e_grad:.2e} (<= {tol:.0e}), max_abs_err {grad_abs:.3e}",
          flush=True)
    if not e_grad <= tol:
        raise SystemExit(f"mesh:train:{tag}: the mixer's gradients on K1 "
                         f"disagree with torch's")
    entries, _, _ = k1_mixer_lines(f"mesh:train:{tag}", f"mesh {label}",
                                   ex, env, adj, launches[0], launches[1:],
                                   grad_abs, torch, split_sx=True)
    del trainer, mp, env, ex, adj, execs
    return run, entries


def mesh_layouts(label, runs) -> None:
    """mesh:train:<label>'s two residual layouts side by side: step ms,
    peak memory, transfer bytes by kind, the bytes remat saved a position
    and the step-1 losses.  Gates: the step-1 losses within
    :data:`MESH_LAYOUT_TOL` of each other, and the saved bytes of every
    position smaller by M under the sequence-parallel layout."""
    seq, rep = runs["sequence-parallel"], runs["replicated"]
    M = seq["M"]
    d = abs(seq["losses"][0] - rep["losses"][0]) / abs(rep["losses"][0])
    ratio = {p: rep["saved"][p] / seq["saved"][p] for p in seq["saved"]
             if seq["saved"][p]}
    print(f"mesh:layouts:{label} on {_nvidia_smi()}: step "
          f"{seq['step_ms']:.4f} ms sequence-parallel / {rep['step_ms']:.4f}"
          f" ms replicated (median of steps 2-6); peak memory {seq['peak']} "
          f"/ {rep['peak']} B; remat's saved bytes a position "
          f"{seq['saved']} / {rep['saved']} (replicated / split {ratio}, M "
          f"= {M}); transfer bytes per step by kind {seq['by_kind']} / "
          f"{rep['by_kind']}; step-1 loss {seq['losses'][0]:.6f} / "
          f"{rep['losses'][0]:.6f} (rel {d:.2e} <= {MESH_LAYOUT_TOL:.0e})",
          flush=True)
    if not (d <= MESH_LAYOUT_TOL and len(ratio) == len(seq["saved"])
            and set(ratio.values()) == {float(M)}):
        raise SystemExit(f"mesh:layouts:{label}: the layouts' step-1 losses "
                         f"differ, or the sequence-parallel layout does not "
                         f"save M times fewer bytes a position")


def mesh_prefill(label, cfg, one_ms, torch) -> None:
    """mesh:prefill:<label>: ``cfg``'s prefill (random weights and taps, B =
    LM_BATCH x LM_PROMPT) on the mesh against one device's; ``one_ms`` is
    one device's prefill ms from an earlier phase of this run, or None:
    then both are timed here, MESH_PREFILL_REPS times each, and the
    model's own bfloat16 noise is printed beside the gate: one device's
    logits against a float32 copy's of the same weights."""
    import dataclasses

    import numpy as np

    from repro_torch import compile_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (ExecConfig, ShapeSpec, init_params,
                                    make_prefill_step, prefill_logits, spmd)
    from repro_torch.models.ssm import _smooth_result, smooth_env

    t0 = time.time()
    gen = torch.Generator(DEVICE).manual_seed(0)
    model = init_params(cfg, generator=gen, device=DEVICE)
    with torch.no_grad():
        model.smooth_taps.copy_(0.5 * torch.randn(
            LM_RADIUS + 1, generator=gen, device=DEVICE))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=DEVICE)
    batch = {"tokens": tokens}
    want = prefill_logits(model, cfg, ExecConfig(), batch)
    reps = MESH_PREFILL_REPS if one_ms is None else 0
    noise = ""
    if one_ms is None:
        ms1 = _time_ms(lambda: prefill_logits(model, cfg, ExecConfig(),
                                              batch), torch, reps)
        one_ms = f"{ms1:.4f} ms (this call)"
        f32 = dataclasses.replace(cfg, dtype="float32")
        copy = init_params(f32, generator=torch.Generator(DEVICE),
                           device=DEVICE)
        with torch.no_grad():
            for a, b in zip(copy.parameters(), model.parameters(),
                            strict=True):
                a.copy_(b)
        w32 = prefill_logits(copy, f32, ExecConfig(), batch)
        noise = (f"; one device's bfloat16 against a float32 copy: max "
                 f"|diff| {float((want - w32).abs().max()):.3e}, argmax "
                 f"equal {bool((want.argmax(-1) == w32.argmax(-1)).all())}")
        del copy, w32
        torch.cuda.empty_cache()
    else:
        one_ms = f"{one_ms} ms (phase 15, this run)"
    mesh = make_mesh(MESH, ("data", "model"), devices=mesh_devices())
    rows, m = MESH
    x = model.embed[tokens[:LM_BATCH // rows]][..., :cfg.d_model // m]
    res = _smooth_result(LM_PROMPT, x.shape[0] * x.shape[2], LM_RADIUS)
    ex = compile_plan(res.plan, smooth_env(x, model.smooth_taps, LM_RADIUS))
    mp = spmd.place_model(model, mesh)
    del model, x
    torch.cuda.empty_cache()
    step = make_prefill_step(cfg, ExecConfig(mesh=mesh))
    ex.spec.launches = 0  # the main path: one prefill on the mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = step(mp, batch)
    torch.cuda.synchronize()
    launches = ex.kernel_launches
    activation_vs_peak(f"mesh:prefill:{label}", cfg, ShapeSpec(
        "mesh_prefill", LM_PROMPT, LM_BATCH, "prefill"), mesh,
        ExecConfig(mesh=mesh), base, torch.cuda.max_memory_allocated())
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    ms = _time_ms(lambda: step(mp, batch), torch, reps)
    by_kind = mp.last_log.bytes_by_kind()
    print(f"mesh:prefill:{label} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {mesh}): K1 launches {launches} ({ex.backend}); "
          f"logits {tuple(got.shape)} finite "
          f"{bool(torch.isfinite(got).all())}; vs one device argmax equal on "
          f"every row {same}, max |diff| {diff:.3e} (<= "
          f"{LM_LOGITS_TOL:.0e} x {scale:.3e}); {ms:.4f} ms on "
          f"{_nvidia_smi()} against one device's {one_ms}; transfer "
          f"bytes by kind {by_kind}; {time.time() - t0:.1f} s{noise}",
          flush=True)
    if not (same and diff <= LM_LOGITS_TOL * scale
            and bool(torch.isfinite(got).all())
            and launches == len(mp.layout.positions)):
        raise SystemExit(f"mesh:prefill:{label}: the mesh's logits disagree "
                         f"with one device's, or K1 did not run once on "
                         f"every position")
    del mp, want, got
    torch.cuda.empty_cache()


def mesh_parity(label, cfg, torch) -> None:
    """mesh:parity:<label>: ``cfg`` (float32) on the mesh: teacher-forced
    mesh decode against the mesh prefill."""
    import numpy as np

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (ExecConfig, init_params,
                                    make_decode_step, make_prefill_step,
                                    spmd)

    mesh = make_mesh(MESH, ("data", "model"), devices=mesh_devices())
    model = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(1),
                        device=DEVICE)
    mp = spmd.place_model(model, mesh)
    del model
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_PARITY_BATCH, LM_PARITY_PROMPT)), device=DEVICE)
    ec = ExecConfig(mesh=mesh)
    want = make_prefill_step(cfg, ec)(mp, {"tokens": tokens})
    caches = spmd.init_caches(mp, LM_PARITY_BATCH, LM_PARITY_PROMPT)
    step = make_decode_step(cfg, ec, LM_PARITY_PROMPT)
    for t in range(LM_PARITY_PROMPT):
        got, caches = step(mp, caches, tokens[:, t:t + 1], t)
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    print(f"mesh:parity:{label} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, float32, {mesh}, {LM_PARITY_PROMPT} tokens): mesh "
          f"decode vs mesh prefill max |diff| {diff:.3e} (<= 1e-3 x "
          f"{scale:.3e})", flush=True)
    if not diff <= 1e-3 * scale:
        raise SystemExit(f"mesh:parity:{label}: the mesh's decode does not "
                         f"reproduce its prefill")
    del mp, caches
    torch.cuda.empty_cache()


def mixer_vs_conv1d(torch) -> None:
    """K1 against the library calls at mesh positions' mixer shapes (``sx``
    (LM_PROMPT + R + 2) x MIXER_CONV_CHANNELS) and at the full-width mixer
    (phase 16's one-device step: its batch x qwen2-7b's d_model channels):
    the forward and the ``sx`` adjoint against ``F.conv1d``
    (:func:`mixer_library_call`, :func:`sx_adjoint_library_call`), the tap
    adjoints (their group's one launch, as the backward runs them, and
    each tap's own three, as before the group; alone and with the sums the
    backward takes of them) against one ``torch.mv`` and one conv1d
    (:func:`tap_adjoint_library_call`); each K1 side but the group also
    at long segments (:func:`long_blocks`: the same plane tile, segments
    of ``SEG_PER_WARMUP`` warm-ups), the taps then writing their products
    for the backward to sum, as before the summed kernel.  Each
    shape's geometries are printed, every side checked first, then timed
    in turns: per round, shape by shape and side by side,
    MIXER_CONV_CALLS calls one at a time (CUDA events around each: the
    host's time per call is in it) and QUEUE_CALLS queued behind a spin
    (:func:`_queued_ms`: the card's time alone), after a warm-up; the
    median of every call per shape and side, and each round's."""
    from repro_torch import compile_plan
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import compile_sources
    from repro_torch.models.ssm import _smooth_result, smooth_env
    from repro_torch.testing import default_tolerances, rel_err

    g = torch.Generator(DEVICE).manual_seed(5)
    g_sy = torch.Generator(DEVICE).manual_seed(6)
    taps = 0.5 * torch.randn(LM_RADIUS + 1, generator=g, device=DEVICE)
    full = _train_arg("--batch") * get_config(LM_ARCH).d_model
    tol = default_tolerances("float32")["baseline"]
    cells = []  # (C, env, forward executor, adjoint triples)
    for C in MIXER_CONV_CHANNELS + (full,):
        x = torch.randn((2, LM_PROMPT, C // 2), generator=g, device=DEVICE,
                        dtype=torch.bfloat16)
        env = smooth_env(x, taps, LM_RADIUS)
        gy = {"sy": torch.randn(env["sy"].shape, generator=g_sy,
                                device=DEVICE)}
        res = _smooth_result(LM_PROMPT, C, LM_RADIUS)
        adj = adjoint_executors(res.program, env, gy)
        (grp,) = [t for t in adj if t[0].members[0].input != "sx"]
        own = spec_executors(grp[0].members, env, gy)
        cells.append((C, env, compile_plan(res.plan, env, "hopper"),
                      [t for t in adj if t is not grp] + own, grp))

    def long(ex, e):
        """The executor of ``ex``'s plan at long segments (``ex`` where
        those are the chooser's)."""
        blocks = long_blocks(ex.spec.tp.geometry)
        return ex if blocks is None else compile_plan(
            ex.plan, e, "hopper", block_rows=blocks[0], block_cols=blocks[1],
            block_inner=blocks[2])

    # the long segments' sources, all at once (the taps': the products)
    compile_sources([long(ex, e).spec.source for _, env, fwd, adj, _ in
                     cells for ex, e in [(fwd, env)] + [
                         (x, a) for _, a, x in adj]])
    sides = {}
    for C, env, ex, adj, grp in cells:
        sw = [t for t in adj if t[0].input != "sx"]
        lib, k1, k1_sums, mv, k1_own, k1_own_sums = tap_adjoint_check(
            f"mixer vs conv1d C={C}", grp, sw, LM_RADIUS, torch)
        old_sw = [(spec, a, long(e, a)) for spec, a, e in sw]
        (adj_env, adj_ex), = [(a, e) for spec, a, e in adj
                              if spec.input == "sx"]
        lib_f = mixer_library_call(env, LM_RADIUS, torch)
        lib_sx = sx_adjoint_library_call(adj_env, LM_RADIUS, torch)
        old_f, old_sx = long(ex, env), long(adj_ex, adj_env)
        for name, e, a, want in (("forward", ex, env, lib_f),
                                 ("forward, long segments", old_f, env,
                                  lib_f),
                                 ("sx adjoint", adj_ex, adj_env, lib_sx),
                                 ("sx adjoint, long segments", old_sx,
                                  adj_env, lib_sx)):
            before = e.kernel_launches
            err = rel_err(want(), e(a))
            torch.cuda.synchronize()
            if (e.backend != "hopper" or e.kernel_launches != before + 1
                    or err > tol):
                raise SystemExit(f"mixer vs conv1d C={C}: K1's {name} is "
                                 f"off K1, did not launch or disagrees "
                                 f"with conv1d ({err:.2e})")
        print(f"mixer geometry C={C} sw group: "
              f"{geometry_text(grp[2].spec.tp.geometry)}", flush=True)
        for name, e, a in (("forward", ex, env),
                           ("sx adjoint", adj_ex, adj_env),
                           ("sw adjoints", sw[0][2], sw[0][1])):
            print(f"mixer geometry C={C} {name}: "
                  f"{geometry_text(e.spec.tp.geometry)}; long segments "
                  f"{geometry_text(long(e, a).spec.tp.geometry)}",
                  flush=True)
        sides[C] = {
            "K1 forward": lambda ex=ex, env=env: ex(env),
            "K1 forward, long segments": lambda e=old_f, a=env: e(a),
            "conv1d forward": lib_f,
            "K1 sx adjoint": lambda e=adj_ex, a=adj_env: e(a),
            "K1 sx adjoint, long segments": lambda e=old_sx, a=adj_env:
                e(a),
            "conv1d sx adjoint": lib_sx,
            "K1 sw group (1 launch)": k1,
            "K1 sw group and its sums": k1_sums,
            "K1 sw adjoints (3 launches)": k1_own,
            "K1 sw products (3 launches), long segments":
                lambda t=old_sw: [e(a) for _, a, e in t],
            "K1 sw adjoints and their sums": k1_own_sums,
            "K1 sw products and their sums, long segments":
                lambda t=old_sw: [e(a)[s.gu].sum() for s, a, e in t],
            "mv sw adjoints": mv, "conv1d sw adjoints": lib}
    calls = {}  # a side slower than MIXER_CONV_SLOW_MS: one call a round
    for C, fns in sides.items():
        for k, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            calls[C, k] = (1 if (time.perf_counter() - t) * 1e3
                           > MIXER_CONV_SLOW_MS else MIXER_CONV_CALLS)
    times = {(C, k): [] for C in sides for k in sides[C]}
    rounds = {k: [] for k in times}
    queued = {k: [] for k in times}
    for _ in range(MIXER_CONV_ROUNDS):
        for C, fns in sides.items():
            for k, fn in fns.items():
                ts = []
                for _ in range(calls[C, k]):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    fn()
                    b.record()
                    b.synchronize()
                    ts.append(a.elapsed_time(b))
                times[C, k] += ts
                rounds[C, k].append(statistics.median(ts))
                if calls[C, k] > 1:
                    queued[C, k].append(_queued_ms(fn, torch)[0])
    smi = _nvidia_smi()
    for (C, k), ts in times.items():
        q = queued[C, k]
        print(f"mixer vs conv1d on {smi}: sx "
              f"({LM_PROMPT + LM_RADIUS + 2}, {C}) {k} median "
              f"{statistics.median(ts):.4f} ms over {len(ts)} calls, queued "
              f"{f'{statistics.median(q):.4f}' if q else 'not measured'}; "
              f"per round {[round(r, 4) for r in rounds[C, k]]}, queued "
              f"{[round(r, 4) for r in q]}", flush=True)


def mesh_cli(root, torch) -> None:
    """``python -m repro_torch.launch.train --mesh 2x2 --devices ...`` on
    qwen2's reduced config with the mixer, in this process."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    argv = MESH_CLI_ARGV + ["--devices", ",".join(mesh_devices()),
                            "--ckpt-dir", str(root / "build" / "mesh_cli")]
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"mesh cli: launch.train {' '.join(argv)} -> {out} in "
          f"{time.time() - t0:.1f} s", flush=True)
    import shutil

    shutil.rmtree(root / "build" / "mesh_cli", ignore_errors=True)
    if out["steps"] != 3 or not math.isfinite(out["final_loss"]):
        raise SystemExit("mesh cli: launch.train --mesh did not train")


def mesh_dryrun(root) -> None:
    """One port dry-run record: qwen2_7b x train_4k on the 16x16 pod (a
    mesh of meta devices, on the host)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import roofline

    t0 = time.time()
    rec = dryrun.run_cell("qwen2_7b", "train_4k", False,
                          root / "build" / "dryrun_torch", force=True)
    if not rec.get("ok"):
        raise SystemExit(f"dryrun: {rec.get('error')}")
    tot, mem = rec["totals"], rec["full"]["memory"]
    terms = roofline(tot["flops_per_device"],
                     tot["analytic_hbm_bytes_per_device"],
                     tot["coll_bytes_per_device"])
    print(f"dryrun qwen2_7b.train_4k.pod ({time.time() - t0:.1f} s, "
          f"{rec['full']['positions_run']}): flops/device "
          f"{tot['flops_per_device']:.4e}, argument bytes "
          f"{mem['argument_size_in_bytes']}, activations (analytic) "
          f"{mem['temp_size_in_bytes']:.4e}, fits 80 GB "
          f"{mem['fits_h100_80gb']}, collective bytes/device "
          f"{tot['coll_bytes_per_device']:.4e}; roofline on H100 data-sheet "
          f"figures: compute {terms.compute_s:.4f} s, memory "
          f"{terms.memory_s:.4f} s, collective {terms.collective_s:.4f} s "
          f"({terms.dominant})", flush=True)


def mesh_main(root, prefill_ms, torch) -> list:
    """Phase 18: the LM on a mesh; returns the kernel-line entries."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import unit_kinds

    t0 = time.time()
    entries = []
    for label, argv in MESH_TRAIN_CELLS:
        entries += mesh_train(root, label, argv, torch)
    mesh_prefill("qwen2-7b", get_config(LM_ARCH).scaled(
        race_smooth_radius=LM_RADIUS), prefill_ms, torch)
    for label, arch, layers in MESH_RECURRENT:
        mesh_prefill(label, get_config(arch).scaled(
            race_smooth_radius=LM_RADIUS, num_layers=layers), None, torch)
    mesh_parity("qwen2-7b", get_config(LM_ARCH).scaled(
        num_layers=LM_PARITY_LAYERS, dtype="float32",
        race_smooth_radius=LM_RADIUS), torch)
    for label, arch, _ in MESH_RECURRENT:
        cfg = get_config(arch)
        mesh_parity(label, cfg.scaled(
            num_layers=MESH_PARITY_UNITS * len(unit_kinds(cfg)),
            dtype="float32"), torch)
    mixer_vs_conv1d(torch)
    mesh_cli(root, torch)
    mesh_dryrun(root)
    print(f"phase 18: {time.time() - t0:.1f} s", flush=True)
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    if sys.argv[1:] == ["--store-hit"]:  # phase 12's fresh process
        store_hit(torch)
        return 0
    if sys.argv[1:2] == ["--k1-cells"]:  # one turn of --step-turns
        sys.path[0] = str(Path(sys.argv[2]).resolve() / "src")
        k1_cells(torch)
        return 0
    # a fresh tuning store: phases 1-11 hold "auto" to the kernel on an
    # empty store, and no record of the user's can change them
    store = root / "build" / "smoke_tuning"
    import shutil

    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    os.environ["RACE_TUNING_CACHE"] = str(store)

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
    from repro_torch.testing import (SWEEP_SIZES, default_tolerances,
                                     rel_err, torch_env)
    from repro_torch.testing.differential import dtype_name

    t_start = time.time()
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    sweeps = {"--tile-sweep": tile_sweep, "--tf32-sweep": tf32_sweep,
              "--mixer-sweep": mixer_sweep}
    if len(sys.argv) == 2 and sys.argv[1] in sweeps:
        sweeps[sys.argv[1]](torch)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(smi)
        return 0
    if sys.argv[1:2] == ["--step-turns"] and len(sys.argv) >= 3:
        step_turns(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3
                   else STEP_ROUNDS, torch)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(smi)
        return 0
    if sys.argv[1:] == ["--lm"]:  # phases 1, 2 (the mixers) and 15 alone
        t0 = time.time()
        compile_sources(lm_sources())
        print(f"build: the mixers' sources in {time.time() - t0:.1f} s",
              flush=True)
        kernels = [lm_main(torch)[0]]
        lm_parity(torch)
        lm_families(torch)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(json.dumps({"kernels": kernels}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--mesh"]:  # phases 1, 2 (its mixers) and 18 alone
        t0 = time.time()
        compile_sources(mesh_sources())
        print(f"build: the mesh's mixer sources in {time.time() - t0:.1f} s",
              flush=True)
        kernels = mesh_main(root, None, torch)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(json.dumps({"kernels": kernels}))
        print(smi)
        return 0
    if sys.argv[1:] in (["--train"], ["--shard"]):
        # phases 1, 2 (the mixers) and 16 alone; --shard adds 17, which
        # re-shards 16's checkpoint
        t0 = time.time()
        compile_sources(train_sources())
        print(f"build: the training mixers' sources in "
              f"{time.time() - t0:.1f} s", flush=True)
        kernels, _ = train_main(root, torch)
        train_resume(root, torch)
        if sys.argv[1] == "--shard":
            elastic_check(root, torch)
            grad_sync_check(torch)
        else:
            import shutil

            shutil.rmtree(root / "build" / "train_ckpt", ignore_errors=True)
        print(f"total seconds: {time.time() - t_start:.1f}")
        print(json.dumps({"kernels": kernels}))
        print(smi)
        return 0

    # ---- plans of phases 3 and 4 ------------------------------------------
    sweep = []  # (case, level, dtype, RaceResult)
    for name in CASES:
        case = get_case(name, SWEEP_SCALE * SWEEP_SIZES[name])
        for lvl in sorted({0, case.reassociate}):
            res = race(case.program, reassociate=lvl,
                       rewrite_div=case.rewrite_div)
            for dt in (np.float32, np.float64) + HALF_DTYPES:
                sweep.append((case, lvl, dt, res))
    main_runs = [(case, dt, race(case.program, reassociate=case.reassociate))
                 for case, dt in full_size_cells()]
    # phase 4's level-0 turns
    level0_runs = [(case, dt, race(case.program, reassociate=0))
                   for case, dt in full_size_cells()
                   if case.name in LEVEL0_CELLS]
    half_runs = [(case, dt, race(case.program, reassociate=case.reassociate))
                 for case, dt in half_cells()]
    # the gradient sweep runs each case at its default level, in float32
    grad_cases = [(case, res) for case, lvl, dt, res in sweep
                  if lvl == case.reassociate and dt is np.float32]

    marks = [(1, t_start)]  # (phase, start) for the phase seconds
    # ---- phase 2: build ----------------------------------------------------
    marks.append((2, time.time()))
    sources = []
    for case, _, dt, res in sweep + [(c, None, d, r) for c, d, r in
                                     main_runs + half_runs + level0_runs]:
        shapes = required_shapes(case.program)
        sources.append(specialize_stencil(
            res.plan, shapes, {k: dtype_name(dt) for k in shapes}).source)
    for case, res in grad_cases:
        sources += adjoint_sources(case, res, np.float32, members=False)
    for case, dt, res in main_runs + half_runs[:1]:
        sources += adjoint_sources(case, res, dt)
    batch_runs = [(label, case, dt, B, race(case.program,
                                            reassociate=case.reassociate))
                  for label, case, dt, B in batch_cells()]
    for _, case, dt, B, res in batch_runs:  # phase 13's cells' too
        sources += geometry_sources(res.plan, required_shapes(case.program),
                                    np.dtype(dt).name, B)
    # the batched gradient and the HVP (phases 9-10): j3d27pt n=256 f32
    for b in (1, batch_runs[0][3]):
        sources += adjoint_sources(batch_runs[0][1], batch_runs[0][4],
                                   np.float32, b, members=False)
    # phase 11: the twins' plans (the same as their DSL cases')
    twin_runs = [(case, dt, race(case.program, reassociate=case.reassociate))
                 for case, dt in twin_cells()]
    for case, dt, res in twin_runs:
        shapes = required_shapes(case.program)
        sources.append(specialize_stencil(
            res.plan, shapes, {k: np.dtype(dt).name for k in shapes}).source)
    # phase 12: every tile candidate of the tuner's grid
    from repro_torch.tuning import candidate_sources

    for _, case, dt, _ in tuning_cells():
        sources += candidate_sources(case.program, shape_env(case, dt),
                                     **{k: v for k, v in tune_opts(
                                         case).items()
                                        if k != "batch_sizes"})
    # phase 14: the sharded local plans, forward and adjoint
    mesh = shard_mesh(torch)
    sources += shard_sources(mesh)
    # phases 5 and 14: the fault programs, single-device and sharded
    sources += fault_sources(mesh)
    # phases 15-16: the LM mixers' plans, and the training mixers' adjoints
    sources += lm_sources() + train_sources() + mesh_sources()
    sources += constant_sources()
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
        env = torch_env(case, dt, seed=1, device="cuda")
        ex = compile_plan(res.plan, env, "hopper")
        before = ex.kernel_launches
        got = res.run(env, "hopper")
        launched = ex.kernel_launches - before
        plain = res.run(env, "torch")
        env64 = {k: v.double() for k, v in env.items()}
        truth = interior(res.plan, res.baseline_evaluator()(env64))
        torch.cuda.synchronize()
        note = ""
        if case.name in F16_OVERFLOW and dtype_name(dt) == "float16":
            keep = {k: v.abs() < FP16_HELD for k, v in truth.items()}
            note = (f" (outputs up to "
                    f"{max(float(v.abs().max()) for v in truth.values()):.4g}"
                    f" overflow float16: held on the {sum(int(m.sum()) for m in keep.values())}"
                    f" of {sum(m.numel() for m in keep.values())} elements "
                    f"under {FP16_HELD:g})")
            got, plain, truth = ({k: o[k].double()[keep[k]] for k in keep}
                                 for o in (got, plain, truth))
        e_plan = rel_err(got, plain)
        e_base = max(rel_err(got, truth), rel_err(plain, truth))
        ok = (launched == 1 and e_plan <= tol["plan"]
              and e_base <= tol["baseline"])
        line = (f"sweep {case.name} r{lvl} {dtype_name(dt)}: "
                f"launches {launched} hopper-vs-torch {e_plan:.2e} "
                f"(<= {tol['plan']:.0e}) vs-baseline {e_base:.2e} "
                f"(<= {tol['baseline']:.0e}) {'ok' if ok else 'FAIL'}{note}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    failures += constant_check(torch)
    if failures:
        raise SystemExit("phase 3 failed:\n" + "\n".join(failures))

    # ---- phase 4: main path at full size ----------------------------------
    marks.append((4, time.time()))
    kernels, schedules = [], []
    f32_twin = {}  # case name -> (env, executor) of its float32 cell
    for case, dt, res in main_runs + half_runs:
        dname = dtype_name(dt)
        label = case.name if dname not in HALF_DTYPES else (
            f"{case.name} {dname}")
        outs = {st.lhs.name for st in case.program.body}
        env = {k: v for k, v in torch_env(case, dt, 0, "cuda").items()
               if k not in outs}
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
        nbytes, ops = plan_work(res.plan, env, ITEMSIZE[dname])
        bound_ms, by = bound_of(nbytes, ops, PEAK_FLOPS[dname])
        tp = ex.spec.tp
        geo = tp.geometry
        if dname in HALF_DTYPES:
            half_turns(label, ex, env, bound_ms, f32_twin[case.name], torch)
        elif dname == "float32" and case.name in dict(HALF_CELLS):
            f32_twin[case.name] = (env, ex)
        if dname == "float32" and case.name in LEVEL0_CELLS:
            level0_turns(label, case, dt, env, ex, torch)
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
              f"{max_abs:.3e}, rel_err {e_plan:.2e}, resources "
              f"{k1_resources(ex.spec.source)}, step "
              f"{k1_step(tp, ex.spec.source)}", flush=True)
        kernels.append(dict(
            name=f"race_stencil[{label}]", route="cuda",
            source="src/repro_torch/lowering/emit.py",
            replaces="src/repro/lowering/emit.py:273",
            launches=launches, max_abs_err=max_abs, ms=kernel_ms,
            plain_ms=torch_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=library_ms))
        schedules.append(dict(
            name=f"race_stencil[{label}]", s_level=geo.s_level,
            plane_tile=[geo.tile[l - 1] for l in geo.order],
            plane_levels=list(geo.order), segment=geo.seg,
            ring_depths={r.name: r.depth for r in geo.rings},
            smem_bytes=tp.smem_bytes,
            aux_evals_per_point=tp.aux_evals_per_point,
            barriers=geo.barriers, rounds_per_point=tp.rounds_per_point,
            lane_use=tp.lane_use, smem_blocks=geo.smem_blocks,
            launch_bounds_blocks=geo.blocks))
        del env, ex, ex_t, lib
        torch.cuda.empty_cache()
    del f32_twin
    torch.cuda.empty_cache()

    # ---- phase 5: gradient sweep -------------------------------------------
    marks.append((5, time.time()))
    failures = grad_sweep(grad_cases, torch) + fault_grads(torch)
    if failures:
        raise SystemExit("phase 5 failed:\n" + "\n".join(failures))

    # ---- phase 6: gradient at full size ------------------------------------
    marks.append((6, time.time()))
    backward = {}  # (case name, dtype name) -> (backward ms, adjoints ms)
    for case, dt, res in main_runs + half_runs[:1]:  # + j3d27pt float16
        entries, backward_ms = grad_full_size(case, dt, res, torch)
        kernels += entries
        backward[case.name, dtype_name(dt)] = (backward_ms, entries[0]["ms"])
        torch.cuda.empty_cache()
    (h_ms, h_adj), (f_ms, f_adj) = (backward["j3d27pt", d]
                                    for d in ("float16", "float32"))
    print(f"grad-main j3d27pt float16 beside float32 (this run, "
          f"{_nvidia_smi()}): backward_ms {h_ms:.4f} / {f_ms:.4f} "
          f"({h_ms / f_ms:.3f}), adjoint kernels {h_adj:.4f} / "
          f"{f_adj:.4f} ({h_adj / f_adj:.3f})", flush=True)

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

    # ---- phase 11: the capture frontend, traced ----------------------------
    marks.append((11, time.time()))
    phase4_ms = {k["name"]: k["ms"] for k in kernels}
    for case, dt, res in twin_runs:
        kernels.append(twin_main(case, dt, res, phase4_ms.get(
            f"race_stencil[{case.name}]"), torch))
        torch.cuda.empty_cache()
    obs_trace(torch)
    torch.cuda.empty_cache()
    obs_cost(torch)

    # ---- phase 12: the autotuner on the card -------------------------------
    marks.append((12, time.time()))
    from repro_torch.serve.warm import store_plan_keys

    decisions = [(case, dt, tune_main(label, case, dt, batch_sizes, torch))
                 for label, case, dt, batch_sizes in tuning_cells()]
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--store-hit"],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"phase 12's fresh process exited "
                         f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    for case, dt, dec in decisions[:len(TUNE_CELLS)]:
        kernels.append(tuned_check(case, dt, dec, torch))
        torch.cuda.empty_cache()
    n_records = len({(ph, sig) for ph, sig, _ in store_plan_keys()})
    store_cost(torch)

    # ---- phase 13: the serving runtime on the card -------------------------
    marks.append((13, time.time()))
    for cell in SERVE_CELLS:
        kernels.append(serve_main(*cell, torch))
        torch.cuda.empty_cache()
    serve_tools(n_records)

    # ---- phase 14: sharded execution on a 2x2 mesh -------------------------
    marks.append((14, time.time()))
    print(f"shard mesh: {mesh}", flush=True)
    for name, n in SHARD_CELLS:
        kernels.append(shard_main(name, n, mesh, torch))
        torch.cuda.empty_cache()
    shard_grad(mesh, torch)
    torch.cuda.empty_cache()
    shard_faults(mesh, torch)
    shard_refusal(mesh, torch)
    copy_bandwidth(torch)
    torch.cuda.empty_cache()

    # ---- phase 15: the LM stack on the card --------------------------------
    marks.append((15, time.time()))
    entry, prefill_ms = lm_main(torch)
    kernels.append(entry)
    lm_parity(torch)
    lm_families(torch)
    torch.cuda.empty_cache()

    # ---- phase 16: the LM training path on the card -------------------------
    marks.append((16, time.time()))
    entries, _ = train_main(root, torch)
    kernels += entries
    train_resume(root, torch)
    torch.cuda.empty_cache()

    # ---- phase 17: the LM's placement layer on the card --------------------
    marks.append((17, time.time()))
    elastic_check(root, torch)
    grad_sync_check(torch)
    torch.cuda.empty_cache()

    # ---- phase 18: the LM on a 2x2 mesh ------------------------------------
    marks.append((18, time.time()))
    kernels += mesh_main(root, f"{prefill_ms:.4f}", torch)

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
