"""Step builders of the port (``repro/models/steps.py``): the loss and the
train step, and the prefill and decode steps the launchers call."""
from __future__ import annotations

from typing import Optional

import torch

from ..optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                     cosine_schedule)
from ..tree import flat_parts, from_parts
from .common import ExecConfig, chunked_ce_loss
from .config import ModelConfig
from .model import decode_step as _decode
from .model import forward_hidden, prefill_logits


def make_loss_fn(cfg: ModelConfig, exec_cfg: ExecConfig,
                 n_units_override: Optional[int] = None):
    def loss_fn(params, batch):
        h = forward_hidden(params, cfg, exec_cfg, batch, n_units_override)
        return chunked_ce_loss(h, params.head, batch["labels"], exec_cfg,
                               mask=batch.get("mask"))

    return loss_fn


def grads_of(loss: torch.Tensor, params) -> dict:
    """The gradient of ``loss`` as ``params.param_tree()`` (an LM's leaves,
    unit leaves as :class:`~repro_torch.tree.Stack` s); a parameter the
    loss does not reach gets zeros."""
    tree = params.param_tree()
    flat = flat_parts(tree)
    if not flat[0].requires_grad:
        raise ValueError("the model's parameters are frozen: make it with "
                         "init_params(..., trainable=True) or "
                         "from_reference(..., trainable=True)")
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return from_parts(tree, [torch.zeros_like(t) if g is None else g
                             for t, g in zip(flat, gs)])


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    exec_cfg: ExecConfig,
                    n_units_override: Optional[int] = None,
                    total_steps: int = 100_000, warmup: int = 1_000):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm", "lr"})`` as the reference's: the loss, its gradient
    over the parameters in the reference's leaf order, clipped to
    ``opt_cfg.clip_norm``, then AdamW at ``cosine_schedule(step + 1)``.
    ``params`` (a trainable LM) is updated in place."""
    loss_fn = make_loss_fn(cfg, exec_cfg, n_units_override)

    def train_step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads_of(loss, params),
                                           opt_cfg.clip_norm)
        lr = cosine_schedule(opt_state["step"] + 1, opt_cfg.lr, warmup,
                             total_steps)
        params, new_opt = adamw_update(params, grads, opt_state, opt_cfg, lr)
        return params, new_opt, {"loss": loss.detach(), "gnorm": gnorm,
                                 "lr": lr}

    return train_step


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
