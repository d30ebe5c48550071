"""Prefill and decode step builders of the port (``repro/models/steps.py``):
the functions the launcher calls.  The training steps (``make_loss_fn``,
``make_train_step``) come with the training path (ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

from typing import Optional

from .common import ExecConfig
from .config import ModelConfig
from .model import decode_step as _decode
from .model import prefill_logits


def make_prefill_step(cfg: ModelConfig, exec_cfg: ExecConfig,
                      n_units_override: Optional[int] = None):
    def prefill_step(params, batch):
        return prefill_logits(params, cfg, exec_cfg, batch, n_units_override)

    return prefill_step


def make_decode_step(cfg: ModelConfig, exec_cfg: ExecConfig, max_len: int,
                     n_units_override: Optional[int] = None):
    def decode_one(params, caches, token, pos):
        return _decode(params, caches, cfg, exec_cfg, token, pos,
                       max_len=max_len)

    return decode_one
