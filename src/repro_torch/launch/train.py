"""Training launcher of the PyTorch port (``repro/launch/train.py``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_7b \\
        --num-layers 4 --batch 4 --seq 512 --steps 6 --race-smooth 2

trains on ``--device`` (default ``cuda``; raises without a card, nothing
runs on the CPU unless ``--device cpu`` is given) through
:class:`repro_torch.runtime.Trainer`: weights drawn by a ``torch.Generator``
seeded 0 on the device, AdamW with the reference's cosine schedule, the
deterministic synthetic pipeline (or ``--token-file``), a checkpoint every
``--ckpt-every`` steps and at the end.  ``--race-smooth R`` turns on the
RACE mixer (``examples/train_lm.py``'s flag), whose forward and backward run
on K1 on a card.  ``--reduced`` takes the family-faithful small config.

``--mesh 2x2`` trains on a (``data``, ``model``) mesh of that shape, as the
reference's ``--mesh`` does, through :mod:`repro_torch.models.spmd`: by
default the first ``prod(shape)`` CUDA cards (fewer raise
:class:`~repro_torch.launch.mesh.AbstractMeshError`; nothing falls back to
one device).  ``--devices cuda:0,cuda:0,cuda:0,cuda:0`` (or ``cpu,...``)
names the mesh's devices instead, one per position and repeats allowed: the
counterpart of the reference's ``--xla_force_host_platform_device_count``.

Prints the reference's JSON line: arch, steps, first and final loss,
tokens/s, restarts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--token-file", default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2': train on a (data, model) mesh")
    ap.add_argument("--devices", default=None,
                    help="the mesh's devices, comma-separated, one per "
                         "position (repeats allowed; default: the first "
                         "CUDA cards)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--race-smooth", type=int, default=0, metavar="R",
                    help="race_smooth_radius (0: no RACE mixer)")
    ap.add_argument("--no-seq-parallel", action="store_true",
                    help="on a mesh, hold every row's whole residual stream "
                         "on each of its members (default: sequence-split "
                         "over model between layer units, the "
                         "reference's layout)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run here)")
    return ap


def model_config(args):
    """The model configuration :func:`setup` trains, from parsed ``args``
    (nothing allocated)."""
    from ..configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {"race_smooth_radius": args.race_smooth}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.num_layers:
        overrides["num_layers"] = args.num_layers
    return dataclasses.replace(cfg, **overrides)


def train_mesh(args):
    """The mesh ``--mesh`` and ``--devices`` ask for, or None."""
    from .mesh import AbstractMeshError, make_mesh

    if not args.mesh:
        if args.devices:
            raise ValueError("--devices names a mesh's devices: give --mesh")
        return None
    shape = tuple(int(x) for x in args.mesh.split("x"))
    devices = args.devices.split(",") if args.devices else None
    mesh = make_mesh(shape, ("data", "model")[:len(shape)], devices)
    if mesh.abstract:
        import torch

        raise AbstractMeshError(
            f"--mesh {args.mesh} needs {mesh.size} CUDA cards, this machine "
            f"has {torch.cuda.device_count()}: name the devices with "
            f"--devices (repeats allowed)")
    return mesh


def exec_config(args, mesh=None):
    """The :class:`~repro_torch.models.ExecConfig` :func:`setup` trains
    with: chunks sized to ``--seq``."""
    from ..models import ExecConfig

    return ExecConfig(attn_chunk_q=min(128, args.seq),
                      attn_chunk_k=min(256, args.seq),
                      ssm_chunk=min(64, args.seq),
                      loss_chunk=min(128, args.seq), mesh=mesh,
                      seq_parallel=not getattr(args, "no_seq_parallel",
                                               False))


def setup(args):
    """(config, a :class:`~repro_torch.runtime.Trainer` ready to ``run``)
    for parsed ``args``."""
    import torch

    from ..core.executor import resolve_device
    from ..data import DataConfig, ShardedTokenPipeline
    from ..models import init_params, make_train_step, spmd
    from ..optim import AdamWConfig, adamw_init
    from ..runtime import Trainer, TrainerConfig

    mesh = train_mesh(args)
    dev = (mesh.devices.flat[0] if mesh is not None
           else resolve_device(args.device))
    cfg = model_config(args)

    exec_cfg = exec_config(args, mesh)
    params = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev, trainable=True)
    opt_cfg = AdamWConfig(lr=args.lr)
    if mesh is not None:
        model, params = params, spmd.place_model(params, mesh)
        del model  # the shards are copies: free the single-device model
        opt = spmd.adamw_init(params, opt_cfg)
    else:
        opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, exec_cfg, total_steps=args.steps,
                           warmup=max(1, args.steps // 20))
    pipe = ShardedTokenPipeline(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        token_file=args.token_file))
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every)
    return cfg, Trainer(tc, step, pipe, params, opt)


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, trainer = setup(args)
    t0 = time.time()
    out = trainer.run()
    dt = time.time() - t0
    tok_s = args.batch * args.seq * len(out["losses"]) / max(dt, 1e-9)
    print(json.dumps({
        "arch": cfg.name, "steps": out["step"],
        "final_loss": out["losses"][-1] if out["losses"] else None,
        "first_loss": out["losses"][0] if out["losses"] else None,
        "tokens_per_s": round(tok_s, 1),
        "restarts": out["restarts"],
    }))


if __name__ == "__main__":
    main()
