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
                    help="not yet: raises (training on a mesh is the port's "
                         "next slice)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--race-smooth", type=int, default=0, metavar="R",
                    help="race_smooth_radius (0: no RACE mixer)")
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


def setup(args):
    """(config, a :class:`~repro_torch.runtime.Trainer` ready to ``run``)
    for parsed ``args``."""
    import torch

    from ..core.executor import resolve_device
    from ..data import DataConfig, ShardedTokenPipeline
    from ..models import ExecConfig, init_params, make_train_step
    from ..optim import AdamWConfig, adamw_init
    from ..runtime import Trainer, TrainerConfig

    if args.mesh:
        raise ValueError(
            "--mesh: training on a mesh is the port's next slice (ROADMAP "
            "Queue 1, item 9.3's second half: single-controller mesh "
            "execution); the meshes and sharding rules are in "
            "repro_torch.launch.mesh and repro_torch.models.sharding, and "
            "the port trains on one device")
    dev = resolve_device(args.device)
    cfg = model_config(args)

    exec_cfg = ExecConfig(attn_chunk_q=min(128, args.seq),
                          attn_chunk_k=min(256, args.seq),
                          ssm_chunk=min(64, args.seq),
                          loss_chunk=min(128, args.seq))
    params = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev, trainable=True)
    opt_cfg = AdamWConfig(lr=args.lr)
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
