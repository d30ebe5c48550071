"""Dry run of the port on the production meshes (counterpart of
``repro/launch/dryrun.py``), on PyTorch's meta device::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b \\
        --shape train_4k --mesh pod

For every runnable (architecture x shape) cell and each mesh (one pod,
16x16 ``data`` x ``model``; two pods, 2x16x16) the cell's step — the train,
prefill or decode step of :mod:`repro_torch.models.spmd` — runs on a mesh
of ``torch.device("meta")``: shapes flow through every operation, nothing
is allocated or computed.  Every position of an SPMD mesh runs the same
program, so one position's program runs, the others' shards and partial
results standing in by their shapes (the record's ``full.positions_run``
says so).  A cell's record holds:

* **per-device bytes**, exact: the shard shapes of ``launch/specs.py``'s
  parameters, optimizer state, batch and caches at one position
  (``full.memory.argument_size_in_bytes``), with an analytic activation
  term (``temp_size_in_bytes``, labelled analytic: each family's unit
  term fitted to what one unit saves for backward,
  :func:`measured_unit_bytes`) and a verdict against one H100's 80 GB;
* **FLOPs per device** from ``torch.utils.flop_counter.FlopCounterMode``
  over probes of one and two layer units with every loop unrolled (the
  reference's probes), extrapolated to ``f1 + (L - 1)(f2 - f1)``; the RACE
  mixer runs no kernel on the meta device and the counter does not see K1,
  so its operations are the RACE plans' own count (each plan's operations
  per point times its points, forward and adjoint);
* **operand bytes** (every operation's inputs and outputs, unfused: the
  counterpart of XLA's "bytes accessed", an upper bound) beside the
  reference's analytic HBM term;
* **collective bytes** from the step's transfer log, with the reference's
  wire models (:mod:`.hlo_analysis`).

Records go to ``build/dryrun_torch/<arch>.<shape>.<mesh>.json`` (``--out``
moves them), never to ``experiments/dryrun/``, which holds the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from math import prod
from pathlib import Path

OUT_DEFAULT = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def _opt_cfg(cfg):
    from ..optim import AdamWConfig

    big = cfg.n_params() > 5e10
    return AdamWConfig(factored=cfg.n_params() > 1e11,
                       m_dtype="bfloat16" if big else "float32")


def meta_mesh(multi_pod: bool, shape=None):
    """The production mesh (or ``shape`` over ``data``, ``model``) as a mesh
    of meta devices."""
    from .mesh import make_mesh

    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model")[:len(shape)])
    return make_mesh(shape, axes, devices=["meta"] * prod(shape))


def shard_bytes(structs) -> int:
    """Bytes one mesh position holds of a tree of
    :class:`~repro_torch.launch.specs.TensorStruct` s: each dimension
    divided by the mesh axes its spec splits it over."""
    import torch

    from ..tree import leaves

    total = 0
    for s in leaves(structs):
        mesh, spec = s.sharding.mesh, tuple(s.sharding.spec)
        n = 1
        for dim, axes in zip(s.shape, spec + (None,) * len(s.shape)):
            axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
            n *= prod(mesh.shape[a] for a in axes)
        total += prod(s.shape) // n * torch.empty(
            (), dtype=s.dtype).element_size()
    return total


def argument_bytes(cfg, shape, mesh, exec_cfg) -> dict:
    """Per-device bytes of the step's arguments, by part, and their sum."""
    from . import specs as S

    out = {}
    if shape.mode == "train":
        p, o = S.param_structs(cfg, mesh, opt_cfg=_opt_cfg(cfg))
        out = {"params": shard_bytes(p), "opt": shard_bytes(o),
               "batch": shard_bytes(S.batch_structs_sharded(cfg, mesh,
                                                            shape))}
    elif shape.mode == "prefill":
        p, _ = S.param_structs(cfg, mesh)
        out = {"params": shard_bytes(p),
               "batch": shard_bytes(S.batch_structs_sharded(cfg, mesh,
                                                            shape))}
    else:
        p, _ = S.param_structs(cfg, mesh)
        out = {"params": shard_bytes(p),
               "caches": shard_bytes(S.cache_structs(
                   cfg, mesh, shape, kv_quant=exec_cfg.kv_quant)),
               "token": shard_bytes(S.decode_token_struct(cfg, mesh, shape))}
    out["total"] = sum(out.values())
    return out


def activation_bytes(cfg, shape, mesh, exec_cfg=None) -> float:
    """The sum of :func:`activation_parts`."""
    return float(sum(activation_parts(cfg, shape, mesh, exec_cfg).values()))


def activation_parts(cfg, shape, mesh, exec_cfg=None) -> dict:
    """Analytic per-device activation memory (the model at bf16), fitted
    to a measurement (:func:`measured_unit_bytes`), not derived.  Train
    keeps each unit's input under remat (L x tokens x D x 2, a member's
    S / M tokens where :func:`~repro_torch.models.spmd.seq_layout` holds)
    plus the working set of the one unit the backward recomputes: what
    that unit saves for backward (:func:`unit_parts`), plus two float32
    logit chunks of the member's vocab; prefill a unit's working set
    (its scan one chunk at a time: nothing is saved under no_grad);
    decode a few token-wide vectors.  ``exec_cfg`` defaults to
    ``ExecConfig()`` (``seq_parallel`` on, as the reference's).  Bytes by
    part: ``saved``, ``layer`` (the unit's norms, projections' inputs,
    attention, MLPs and recurrent blocks' channel tensors), ``moe_buffers``
    (moe: routing, dispatch and combine), ``scan`` (ssm, hybrid: the
    chunked scan's float32 tensors), ``logits`` (train); ``tokens``
    (decode)."""
    from ..models import ExecConfig
    from ..models.sharding import batch_axes
    from ..models.spmd import seq_layout

    rows = prod(mesh.shape[a] for a in batch_axes(mesh))
    M = mesh.shape.get("model", 1)
    split = shape.global_batch % rows == 0
    B_r = shape.global_batch // rows if split else shape.global_batch
    ec = exec_cfg or ExecConfig()
    if shape.mode == "decode":
        return {"tokens": B_r * cfg.d_model * 2 * 16}
    seq = seq_layout(cfg, ec, M, shape.seq_len)
    train = shape.mode == "train"
    parts = unit_parts(cfg, B_r, shape.seq_len, M, rows, seq, ec, train,
                       split)
    if not train:
        return parts
    t, D = B_r * shape.seq_len, cfg.d_model
    chunk = min(512, shape.seq_len)
    return {"saved": cfg.num_layers * t * D * 2 / (M if seq else 1),
            **parts,
            "logits": 2 * B_r * chunk * -(-cfg.vocab // M) * 4}


def unit_parts(cfg, B_r: int, S: int, M: int, R: int, seq: bool, exec_cfg,
               train: bool = True, split: bool = True) -> dict:
    """Bytes one layer unit of ``cfg`` holds for backward at one mesh
    position (``train``), or its working set (prefill): ``B_r`` examples of
    ``S`` tokens a row, ``M`` members, ``R`` rows, ``split`` whether the
    batch splits over them (else every row holds all of it), ``seq``
    whether the stream is sequence-split.  The terms are the
    tensors :func:`measured_unit_bytes` finds, with the widths they are
    saved at, each fitted exactly at two reduced shapes
    (``tests/test_torch_dryrun.py``), per block of the unit:

    * a norm: its float32 input and output and float32 rstd over the
      member's tokens (``tm``: S / M of a row's where ``seq``), and the
      bf16 normed input the block's projections read: the row's t tokens
      (gathered over ``model`` where ``seq``);
    * attention: q and out over the member's query heads, k and v over
      its KV heads (bf16), log-sum-exp (float32); flash attention saves
      no S x S scores, so neither S nor a local window enters;
    * an MLP: seven bf16 (t, F / M) tensors;
    * MoE: the router's float32 input, gates, int64 expert ranks and the
      (token, k) entries over every row's tokens (routing is global);
      per dispatch chunk the row's (E, C / R) slots: the bf16 buffer
      (E, C / R, D) and seven (E, C / R, F / M), the slot index and
      mask; the combine's gathered (t K, D) rows;
    * Mamba: 56 bytes a token and channel of the member's d_inner / M
      (bf16 and float32 channel tensors), the padded conv input, B and C
      at float32, ``x_proj``'s product; the scan (``_assoc``): per chunk
      its 2 k + 1 float32 (B_r, chunk, d_inner / M, N) tensors, k =
      ceil(log2 chunk) Hillis-Steele steps each saving its a and b, and
      hs; h0's fold;
    * RG-LRU: thirteen float32 (t, W / M) gate and branch tensors, the
      padded conv input, the gathered (t, W) conv output, the scan as
      Mamba's at N = 1.

    Keys: ``layer``, and ``moe_buffers`` / ``scan`` where the unit has
    them."""
    import dataclasses
    from math import ceil, log2

    from ..models.model import unit_kinds
    from ..models.spmd import _even, _head_split, _moe_chunks, _split
    from ..models.ssm import _n_chunks

    D, F = cfg.d_model, cfg.d_ff
    t = B_r * S
    tm = t // M if seq else t
    ec = dataclasses.replace(exec_cfg, unroll_scans=False)
    n = _n_chunks(S, ec)  # the scans' time chunks
    steps = ceil(log2(S // n)) if S // n > 1 else 0
    out = {"layer": 0.0}

    def add(key, v):
        out[key] = out.get(key, 0.0) + v

    def width(w):
        lo, hi = _even(w, M, 0)
        return hi - lo

    def norms(k):
        add("layer", k * (8 * tm * D + 4 * tm + 2 * t * D))

    def mlp(f):
        lo, hi = _split(f, M, 0)
        add("layer", 14 * t * (hi - lo))

    def attention():
        sp = _head_split(cfg, M, 0) if M > 1 else None
        kv, g = ((sp[1] - sp[0], sp[3] - sp[2]) if sp is not None else
                 (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads))
        add("layer", 4 * t * (kv * g + kv) * cfg.d_head + 4 * t * kv * g)

    def scan(w, per):
        if train:
            add("scan", (2 * steps + 1) * 4 * t * w * per
                + 4 * n * B_r * w * per)
        else:  # one chunk's dA, dBx and the scan's two pairs at a time
            add("scan", 6 * 4 * B_r * (S // n) * w * per)

    def moe():
        E, K = cfg.moe_experts, cfg.moe_top_k
        T = B_r * S * (R if split else 1)
        nc = _moe_chunks(T, ec)
        Tc = T // nc
        C = max(8, int(Tc * K * cfg.moe_capacity) // E)
        lo, hi = _even(C, R, 0)
        f = width(F)
        routed = T if train else Tc
        chunks = nc if train else 1
        add("moe_buffers",
            routed * (4 * D + 13 * K + 8 * E)
            + chunks * E * (hi - lo) * (9 + 2 * D + 14 * f)
            + t * K * (4 * D + 34))

    for kind in unit_kinds(cfg):
        if kind == "mamba":
            di, N, K = width(cfg.d_inner), cfg.ssm_state, cfg.ssm_conv
            norms(1)
            add("layer", 2 * (t + B_r * (K - 1)) * di + 56 * t * di
                + 8 * t * N + 2 * t * (cfg.dt_rank + 2 * N))
            scan(di, N)
            continue
        norms(2)
        if kind == "rglru":
            W = cfg.lru_width or D
            w = width(W)
            add("layer", 13 * 4 * t * w + 2 * (t + B_r * (cfg.ssm_conv - 1))
                * w + 2 * t * w + 2 * t * W)
            scan(w, 1)
        else:  # attn, cross, moe
            attention()
        if kind == "moe":
            moe()
            if cfg.moe_shared:
                mlp(cfg.moe_shared * F)
        else:
            mlp(F)
    return out


def measured_unit_bytes(cfg, shape, mesh_shape=(2, 2), exec_cfg=None) -> int:
    """Measured: the activation bytes one layer unit of ``cfg`` saves for
    backward at the first position of a ``mesh_shape`` meta mesh, remat
    off, at ``shape``'s batch.  Each count is a train step's saved tensors
    under ``torch.autograd.graph.saved_tensors_hooks``, a storage counted
    once however many operations save it; one unit is the step of two
    units less the step of one, and its activations that unit at twice
    the batch less it at the batch (the unit's weights do not grow with
    the batch)."""
    import dataclasses

    import torch

    from ..models import ExecConfig, spmd
    from ..models.model import LM
    from . import specs as S

    mesh = meta_mesh(False, mesh_shape)
    meta = torch.device("meta")
    ec = dataclasses.replace(exec_cfg or ExecConfig(), remat=False,
                             mesh=mesh)
    opt = _opt_cfg(cfg)

    def saved(n_units, batch) -> int:
        mp = spmd.place_model(LM(cfg, None, meta, n_units), mesh,
                              trainable=True)
        step = spmd.make_train_step(cfg, opt, ec,
                                    positions=[mp.layout.positions[0]])
        state = spmd.adamw_init(mp, opt)
        sh = dataclasses.replace(shape, global_batch=batch)
        inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
                  for k, v in S.batch_struct(cfg, sh).items()}
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step(mp, state, inputs)
        return sum(seen.values())

    B = shape.global_batch
    return ((saved(2, 2 * B) - saved(1, 2 * B))
            - (saved(2, B) - saved(1, B)))


#: aten ops that move no data of their own (views, metadata, allocation)
_NOT_TRAFFIC = {"view", "_unsafe_view", "expand", "permute", "transpose",
                "t", "slice", "select", "unsqueeze", "squeeze", "reshape",
                "alias", "detach", "as_strided", "split", "split_with_sizes",
                "unbind", "empty", "empty_like", "new_empty",
                "empty_strided", "zeros", "zeros_like", "ones_like",
                "lift_fresh", "_to_copy", "copy_"}


def _operand_bytes_mode():
    """A dispatch mode whose ``total`` sums every operation's input and
    output tensor bytes (:data:`_NOT_TRAFFIC` excluded): unfused operand
    traffic."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OperandBytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in _NOT_TRAFFIC:
                self.total += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    return OperandBytes()


def probe(cfg, shape, mesh, exec_cfg, n_units: int) -> dict:
    """One position's step at ``n_units`` layer units on the meta mesh:
    ``{"cost": {"flops", "bytes"}, "coll": collective_traffic,
    "schedule": collective_schedule, "compile_s"}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import spmd
    from ..models.model import LM
    from . import specs as S
    from .hlo_analysis import collective_schedule, collective_traffic

    t0 = time.time()
    meta = torch.device("meta")
    model = LM(cfg, None, meta, n_units)
    train = shape.mode == "train"
    mp = spmd.place_model(model, mesh, trainable=train)
    first = [mp.layout.positions[0]]

    def empty(structs):
        return {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
                for k, v in structs.items()}

    counter = FlopCounterMode(display=False)
    ob = _operand_bytes_mode()
    with counter, ob:
        if train:
            opt = _opt_cfg(cfg)
            state = spmd.adamw_init(mp, opt)
            step = spmd.make_train_step(cfg, opt, exec_cfg, positions=first)
            step(mp, state, empty(S.batch_struct(cfg, shape)))
        elif shape.mode == "prefill":
            step = spmd.make_prefill_step(cfg, exec_cfg, positions=first)
            step(mp, empty(S.batch_struct(cfg, shape)))
        else:
            caches = spmd.init_caches(mp, shape.global_batch, shape.seq_len,
                                      kv_quant=exec_cfg.kv_quant)
            step = spmd.make_decode_step(cfg, exec_cfg, shape.seq_len,
                                         positions=first)
            step(mp, caches, torch.empty((shape.global_batch, 1),
                                         dtype=torch.long, device=meta),
                 shape.seq_len - 1)
    flops = float(counter.get_total_flops()) + mp.last_meta_ops
    return {"cost": {"flops": flops, "bytes": float(ob.total)},
            "coll": collective_traffic(mp.last_log),
            "schedule": collective_schedule(mp.last_log),
            "compile_s": round(time.time() - t0, 2)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, exec_overrides: dict = None, tag: str = "",
             *, cfg=None, shape=None, mesh_shape=None) -> dict:
    """The record of one cell, written to ``out_dir`` (and read back from
    there unless ``force``).  ``cfg``, ``shape`` and ``mesh_shape`` replace
    the arch's config, the named shape and the production mesh (tests run
    reduced cells on a 2x2 meta mesh)."""
    from ..configs import get_config
    from ..models import SHAPES, ExecConfig, cell_is_runnable
    from ..models.model import n_units
    from .hlo_analysis import analytic_hbm_bytes
    from .mesh import HBM_BYTES

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_tag = ("multipod" if multi_pod else "pod") + (f".{tag}" if tag
                                                       else "")
    out = Path(out_dir) / f"{arch}.{shape_name}.{mesh_tag}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    ok, reason = cell_is_runnable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "mode": shape.mode, "runnable": ok, "skip_reason": reason,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "n_units": n_units(cfg),
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    if not ok:
        out.write_text(json.dumps(rec, indent=1))
        return rec
    mesh = meta_mesh(multi_pod, mesh_shape)
    ov = exec_overrides or {}
    rec["exec_overrides"] = ov
    try:
        exec_probe = dataclasses.replace(
            ExecConfig(unroll_scans=True, probe_chunks=2, mesh=mesh), **ov)
        probes = {nu: probe(cfg, shape, mesh, exec_probe, nu)
                  for nu in (1, 2)}
        L = rec["n_units"]
        f1, f2 = (probes[n]["cost"]["flops"] for n in (1, 2))
        b1, b2 = (probes[n]["cost"]["bytes"] for n in (1, 2))
        c1, c2 = (probes[n]["coll"]["bytes"] for n in (1, 2))
        args = argument_bytes(cfg, shape, mesh, exec_probe)
        temp_parts = activation_parts(cfg, shape, mesh, exec_probe)
        temp = float(sum(temp_parts.values()))
        top = probes[1]["schedule"]["top_level"]
        per = probes[1]["schedule"]["per_layer"]
        rec["full"] = {
            "compile_s": round(sum(p["compile_s"] for p in probes.values()),
                               2),
            "cost": {"flops": f1 + (L - 1) * (f2 - f1),
                     "bytes": b1 + (L - 1) * (b2 - b1)},
            "memory": {
                "argument_size_in_bytes": args["total"],
                "argument_parts": args,
                "temp_size_in_bytes": temp, "temp_is_analytic": True,
                "temp_parts": temp_parts,
                "fits_h100_80gb": args["total"] + temp <= HBM_BYTES},
            "positions_run": (f"one of {mesh.size}: every position runs the "
                              f"same program"),
        }
        rec["collective_schedule"] = {"per_layer": per, "top_level": top}
        rec["full_collectives"] = {k: top.get(k, 0) + L * per.get(k, 0)
                                   for k in set(top) | set(per)}
        rec["probes"] = {n: {k: p[k] for k in ("cost", "coll", "compile_s")}
                         for n, p in probes.items()}
        opt = _opt_cfg(cfg)
        opt_bpp = 2.5 if opt.factored else (6 if opt.m_dtype == "bfloat16"
                                            else 8)
        ec = exec_probe
        rec["totals"] = {
            "flops_per_device": f1 + (L - 1) * (f2 - f1),
            "bytes_per_device": b1 + (L - 1) * (b2 - b1),
            "coll_bytes_per_device": c1 + (L - 1) * (c2 - c1),
            "analytic_hbm_bytes_per_device": analytic_hbm_bytes(
                cfg, shape, mesh.size,
                opt_bpp if shape.mode == "train" else 0,
                logits_bytes_per=2 if ec.logits_dtype == "bfloat16" else 4,
                kv_bytes_per=1.07 if ec.kv_quant else 2),
            "per_unit": {"flops": f2 - f1, "bytes": b2 - b1,
                         "coll_bytes": c2 - c1},
        }
        rec["ok"] = True
    except Exception as e:  # record the failure; the sweep keeps going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    from ..configs import ARCHS
    from ..models import SHAPES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=str(OUT_DEFAULT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--exec", action="append", default=[],
                    help="ExecConfig override key=value")
    ap.add_argument("--tag", default="", help="suffix for the result JSON")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in getattr(args, "exec"):
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}.{shape}.{'multipod' if mp else 'pod'}"
                t0 = time.time()
                rec = run_cell(arch, shape, mp, Path(args.out),
                               force=args.force, exec_overrides=overrides,
                               tag=args.tag)
                if not rec["runnable"]:
                    n_skip += 1
                    print(f"SKIP {tag}: {rec['skip_reason']}", flush=True)
                elif rec.get("ok"):
                    n_ok += 1
                    mem = rec["full"]["memory"]
                    print(f"OK   {tag} ({time.time() - t0:.0f}s) "
                          f"args={mem['argument_size_in_bytes'] / 2**30:.2f}"
                          f"GiB temp(analytic)="
                          f"{mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                          f"flops/dev={rec['totals']['flops_per_device']:.3e}",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL {tag}: {rec['error']}", flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
