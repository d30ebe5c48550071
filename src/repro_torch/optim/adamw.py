"""AdamW of the port (``repro/optim/adamw.py``), with the reference's
optional factored second moment (Adafactor-style) and low-precision first
moment:

  plain    : m f32 + v f32            (8 bytes/param extra)
  m_bf16   : m bf16 + v f32           (6 bytes/param)
  factored : m bf16 + row/col v f32   (~2 bytes/param)

The state is ``{"mu": tuple of per-leaf dicts, "step": int32 scalar}`` in
the reference's leaf order (:mod:`repro_torch.tree`), so ``mu[i]`` holds
the same numbers in both packages.  A unit leaf (a :class:`~repro_torch.
tree.Stack` of per-unit parameters) keeps its state stacked, as the
reference's ``(L, ...)`` leaf does: ``factored`` decides and reduces on the
stacked shape, so a per-unit vector (an RMSNorm scale) of L >= 2 units is
factored across its units as in the reference.

Arithmetic is float32, cast back to each parameter's dtype (round to
nearest even, as XLA casts).  :func:`adamw_update` writes the parameters
in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import Stack, as_array, copy_, leaves, like, map_leaves, parts


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    factored: bool = False
    m_dtype: str = "float32"
    clip_norm: float = 1.0


def _tree(params):
    """The leaf tree of ``params``: an LM's ``param_tree()``, else itself."""
    return params.param_tree() if hasattr(params, "param_tree") else params


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warm-up to ``base_lr``, then a cosine down to ``min_frac`` of
    it at ``total``; float32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.m_dtype)

    def leaf(p):
        shape = (len(p),) + tuple(p[0].shape) if isinstance(p, Stack) \
            else tuple(p.shape)
        dev = parts(p)[0].device
        m = torch.zeros(shape, dtype=mdt, device=dev)
        if cfg.factored and _factorable(shape):
            return {"m": m,
                    "vr": torch.zeros(shape[:-1], device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], device=dev)}
        return {"m": m, "v": torch.zeros(shape, device=dev)}

    ps = leaves(_tree(params))
    return {"mu": tuple(leaf(p) for p in ps),
            "step": torch.zeros((), dtype=torch.int32,
                                device=parts(ps[0])[0].device)}


def opt_state_shardings(param_shardings, replicated, cfg: AdamWConfig):
    """Partition specs matching :func:`adamw_init`'s structure, from
    ``(spec, shape)`` per parameter leaf in leaf order: ``m`` and ``v``
    follow their parameter; factored ``vr`` / ``vc`` drop the reduced
    axis's entry.  ``replicated`` is the step's."""
    from ..models.sharding import P

    def leaf(spec_and_shape):
        spec, shape = spec_and_shape
        if cfg.factored and _factorable(shape):
            sp = list(spec) + [None] * (len(shape) - len(spec))
            return {"m": spec,
                    "vr": P(*sp[:-1]),
                    "vc": P(*(sp[:-2] + sp[-1:]))}
        return {"m": spec, "v": spec}

    return {"mu": tuple(leaf(x) for x in param_shardings),
            "step": replicated}


def clip_by_global_norm(grads, max_norm: float):
    """(``grads`` scaled to a global norm of at most ``max_norm``, the
    norm before), each leaf kept in its dtype."""
    gn = torch.sqrt(sum(sum(torch.sum(torch.square(g.float()))
                            for g in parts(leaf)) for leaf in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)

    def clip(leaf):
        out = tuple((g.float() * scale).to(g.dtype) for g in parts(leaf))
        return Stack(out) if isinstance(leaf, Stack) else out[0]

    return map_leaves(clip, grads), gn


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr):
    """One AdamW step: ``params`` updated in place, returned with the new
    state.  ``grads`` has ``params``' leaves (an LM's in ``param_tree``
    order)."""
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def leaf(p_leaf, g_leaf, s):
        p, gf = as_array(p_leaf), as_array(g_leaf).float()
        m = cfg.b1 * s["m"].float() + (1 - cfg.b1) * gf
        if "v" in s:
            v = cfg.b2 * s["v"] + (1 - cfg.b2) * gf * gf
            vhat = v / b2c
            new_s = {"m": m.to(s["m"].dtype), "v": v}
        else:
            vr = cfg.b2 * s["vr"] + (1 - cfg.b2) * torch.mean(gf * gf, -1)
            vc = cfg.b2 * s["vc"] + (1 - cfg.b2) * torch.mean(gf * gf, -2)
            # rank-1 reconstruction: vr x vc / mean(vr)
            denom = torch.clamp(torch.mean(vr, -1, keepdim=True), min=1e-30)
            vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / b2c
            new_s = {"m": m.to(s["m"].dtype), "vr": vr, "vc": vc}
        upd = (m / b1c) / (torch.sqrt(vhat) + cfg.eps)
        upd = upd + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * upd).to(p.dtype)
        copy_(p_leaf, like(p_leaf, new_p))
        return new_s

    mu = tuple(leaf(p, g, s) for p, g, s in zip(
        leaves(_tree(params)), leaves(grads), state["mu"], strict=True))
    return params, {"mu": mu, "step": step}
