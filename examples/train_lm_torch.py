"""End-to-end training on the PyTorch port: data pipeline -> model (on one
device or a mesh) -> AdamW -> async checkpointing -> resume, through the
fault-tolerant Trainer.

    PYTHONPATH=src python examples/train_lm_torch.py --quick      # ~8M params
    PYTHONPATH=src python examples/train_lm_torch.py             # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --quick --mesh 2x2 \\
        --devices cpu,cpu,cpu,cpu

The default configuration is a ~100M-parameter qwen3-family model (d_model
640, 10 layers, 32k vocab) trained a few hundred steps; ``--quick`` runs the
same pipeline at ~8M parameters and 40 steps.  ``--race-smooth R`` routes
the RACE mixer's forward and backward through K1 (on a card).  ``--mesh``
trains on a (``data``, ``model``) mesh (``repro_torch.models.spmd``): the
first cards, or ``--devices`` (repeats allowed).  The port of
``examples/train_lm.py``.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.data import DataConfig, ShardedTokenPipeline  # noqa: E402
from repro_torch.launch.train import train_mesh  # noqa: E402
from repro_torch.models import (ExecConfig, init_params,  # noqa: E402
                                make_train_step, spmd)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--race-smooth", type=int, default=2, metavar="R",
                    help="radius of the RACE-optimized causal FIR mixer "
                         "(fwd+bwd run through the RACE pipeline; 0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run here)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x2': train on a (data, model) mesh")
    ap.add_argument("--devices", default=None,
                    help="the mesh's devices, comma-separated")
    args = ap.parse_args(argv)

    base = get_config("qwen3_14b")
    if args.quick:
        cfg = dataclasses.replace(
            base, name="qwen3-8m", num_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=256, vocab=2048)
        steps, batch, seq = args.steps or 40, 2, 128
    else:
        cfg = dataclasses.replace(
            base, name="qwen3-100m", num_layers=10, d_model=640, n_heads=10,
            n_kv_heads=2, d_head=64, d_ff=1792, vocab=32768)
        steps, batch, seq = args.steps or 300, 8, 512
    cfg = dataclasses.replace(cfg, race_smooth_radius=args.race_smooth)
    print(f"model: {cfg.name}  params={cfg.n_params()/1e6:.1f}M  steps={steps}"
          f"  race_smooth_radius={cfg.race_smooth_radius}")

    mesh = train_mesh(args)
    dev = (mesh.devices.flat[0] if mesh is not None
           else resolve_device(args.device))
    exec_cfg = ExecConfig(attn_chunk_q=min(128, seq),
                          attn_chunk_k=min(128, seq), ssm_chunk=64,
                          loss_chunk=min(128, seq), mesh=mesh)
    params = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev, trainable=True)
    opt_cfg = AdamWConfig(lr=1e-3)
    if mesh is not None:
        params = spmd.place_model(params, mesh)
        opt = spmd.adamw_init(params, opt_cfg)
    else:
        opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, exec_cfg, total_steps=steps,
                           warmup=max(1, steps // 10))
    pipe = ShardedTokenPipeline(DataConfig(seq_len=seq, global_batch=batch,
                                           vocab=cfg.vocab, seed=0))
    tc = TrainerConfig(total_steps=steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=max(10, steps // 4))
    out = Trainer(tc, step, pipe, params, opt).run()
    print(json.dumps({
        "first_loss": round(out["losses"][0], 4),
        "final_loss": round(out["losses"][-1], 4),
        "loss_dropped": out["losses"][-1] < out["losses"][0],
        "steps": out["step"],
        "race_cache": out.get("race_cache", {}),
    }))


if __name__ == "__main__":
    main()
