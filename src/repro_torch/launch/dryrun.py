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
  term (``temp_size_in_bytes``, labelled analytic) and a verdict against
  one H100's 80 GB;
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
    """Analytic per-device activation memory (bf16), not measured: train
    keeps each unit's input under remat (L x tokens x D x 2, a member's
    S / M tokens where :func:`~repro_torch.models.spmd.seq_layout` holds)
    plus one layer's working set, Korthikanti et al.'s at tensor parallel
    degree M and the member's H heads: ``t (34 D / M + 5 H S)`` bytes with
    sequence parallelism, ``t (10 D + 24 D / M + 5 H S)`` without (the
    norms' and residual's tensors whole on every member), plus two float32
    logit chunks of the member's vocab; prefill one layer's working set;
    decode a few token-wide vectors.  ``exec_cfg`` defaults to
    ``ExecConfig()`` (``seq_parallel`` on, as the reference's).  Bytes by
    part: ``saved``, ``layer``, ``logits`` (train), ``layer`` (prefill),
    ``tokens`` (decode)."""
    from ..models import ExecConfig
    from ..models.sharding import batch_axes
    from ..models.spmd import seq_layout

    rows = prod(mesh.shape[a] for a in batch_axes(mesh))
    M = mesh.shape.get("model", 1)
    B_r = (shape.global_batch // rows if shape.global_batch % rows == 0
           else shape.global_batch)
    t = B_r * shape.seq_len
    D, H = cfg.d_model, max(1, cfg.n_heads // M)
    seq = seq_layout(cfg, exec_cfg or ExecConfig(), M, shape.seq_len)
    attn = 5 * H * shape.seq_len
    layer = t * (34 * D / M + attn if seq else 10 * D + 24 * D / M + attn)
    if shape.mode == "train":
        chunk = min(512, shape.seq_len)
        logits = 2 * B_r * chunk * -(-cfg.vocab // M) * 4
        saved = cfg.num_layers * t * D * 2 / (M if seq else 1)
        return {"saved": saved, "layer": layer, "logits": logits}
    if shape.mode == "prefill":
        return {"layer": layer}
    return {"tokens": B_r * D * 2 * 16}


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
