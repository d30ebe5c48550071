"""Model assembly of the port (``repro/models/model.py``): embedding ->
layer units -> norm -> head, as an :class:`LM` module.

The reference stacks each unit's params on a leading axis for ``lax.scan``;
here ``LM.units`` is an ``nn.ModuleList`` of per-kind block modules, unit
after unit (block ``i`` has kind ``unit_kinds(cfg)[i % len(unit_kinds)]``):

  dense/encoder  unit = [attn]                      x L
  moe            unit = [moe]                       x L   (+ optional dense layer 0)
  ssm            unit = [mamba]                     x L
  hybrid         unit = pattern (rglru,rglru,attn)  x L//3 (+ trailing rglru)
  vlm            unit = [attn x (k-1), cross]       x L//k

The entry points keep the reference's names and take the module where the
reference takes its param tree.  Everything runs on the module's device;
:func:`init_params` and :func:`init_caches` default to ``cuda`` and raise
without a GPU unless ``device="cpu"`` is passed.  Caches are updated in
place; :func:`decode_step` still returns ``(logits, caches)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.executor import resolve_device
from .attention import (Attention, attention_block, decode_attention_block,
                        init_kv_cache)
from .common import (ExecConfig, dense_init, init_rmsnorm, mm, mm_f32, param,
                     rmsnorm, rope_angles, torch_dtype)
from .config import ModelConfig
from .moe import MLP, MoE, mlp_block, moe_block
from .ssm import (RGLRU, Mamba, init_mamba_cache, init_rglru_cache,
                  mamba_block, mamba_decode, race_smooth, rglru_block,
                  rglru_decode)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def unit_kinds(cfg: ModelConfig) -> list:
    if cfg.kind in ("dense", "encoder"):
        return ["attn"]
    if cfg.kind == "moe":
        return ["moe"]
    if cfg.kind == "ssm":
        return ["mamba"]
    if cfg.kind == "hybrid":
        return list(cfg.pattern)
    if cfg.kind == "vlm":
        return ["attn"] * (cfg.cross_every - 1) + ["cross"]
    raise ValueError(cfg.kind)


def prelude_kinds(cfg: ModelConfig) -> list:
    if cfg.kind == "moe" and cfg.dense_first_layer_ff:
        return ["dense_attn"]
    return []


def trailing_kinds(cfg: ModelConfig) -> list:
    if cfg.kind == "hybrid":
        return list(cfg.pattern[: cfg.num_layers % len(cfg.pattern)])
    return []


def n_units(cfg: ModelConfig) -> int:
    consumed = len(prelude_kinds(cfg)) + len(trailing_kinds(cfg))
    return (cfg.num_layers - consumed) // len(unit_kinds(cfg))


# ---------------------------------------------------------------------------
# per-kind blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: ``ln1`` and its mixer (``attn``, ``moe``'s attention,
    ``mamba`` or ``rglru``), then ``ln2`` and its MLP or MoE where the kind
    has one — the reference's per-kind param dict, entry for entry."""

    def __init__(self, cfg: ModelConfig, kind: str, generator, device=None):
        super().__init__()
        D = cfg.d_model
        g, dev = generator, device
        self.kind = kind
        self.ln1 = param(init_rmsnorm(D, dev))
        if kind in ("attn", "dense_attn", "cross", "moe"):
            self.attn = Attention(cfg, g, cross=kind == "cross", device=dev)
        elif kind == "mamba":
            self.mamba = Mamba(cfg, g, dev)
        elif kind == "rglru":
            self.rglru = RGLRU(cfg, g, dev)
        else:
            raise ValueError(kind)
        if kind == "mamba":
            return
        self.ln2 = param(init_rmsnorm(D, dev))
        if kind == "moe":
            self.moe = MoE(cfg, g, dev)
        else:
            d_ff = cfg.dense_first_layer_ff if kind == "dense_attn" else 0
            self.mlp = MLP(cfg, g, d_ff, dev)


def init_block(generator, cfg: ModelConfig, kind: str, device=None) -> Block:
    return Block(cfg, kind, generator, device)


def apply_block(x, p: Block, cfg, exec_cfg, kind, rope_cache, vision=None):
    if kind in ("attn", "dense_attn"):
        window = cfg.window if cfg.kind == "hybrid" else 0
        x = x + attention_block(rmsnorm(x, p.ln1), p.attn, cfg, exec_cfg,
                                rope_cache=rope_cache, window=window)
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp)
    if kind == "cross":
        x = x + attention_block(rmsnorm(x, p.ln1), p.attn, cfg, exec_cfg,
                                kv_src=vision)
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp)
    if kind == "moe":
        x = x + attention_block(rmsnorm(x, p.ln1), p.attn, cfg, exec_cfg,
                                rope_cache=rope_cache)
        return x + moe_block(rmsnorm(x, p.ln2), p.moe, cfg,
                             exec_cfg=exec_cfg)
    if kind == "mamba":
        return x + mamba_block(rmsnorm(x, p.ln1), p.mamba, cfg, exec_cfg)
    if kind == "rglru":
        x = x + rglru_block(rmsnorm(x, p.ln1), p.rglru, cfg, exec_cfg)
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp)
    raise ValueError(kind)


def decode_block(x, p: Block, cfg, exec_cfg, kind, cache, pos, rope_cache):
    if kind in ("attn", "dense_attn", "moe"):
        window = cfg.window if cfg.kind == "hybrid" else 0
        a, new_kv = decode_attention_block(
            rmsnorm(x, p.ln1), p.attn, cfg, cache, pos,
            rope_cache=rope_cache, window=window)
        x = x + a
        if kind == "moe":
            return x + moe_block(rmsnorm(x, p.ln2), p.moe, cfg,
                                 exec_cfg=exec_cfg), new_kv
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp), new_kv
    if kind == "cross":
        # vision K/V are precomputed in the cache; no update, no mask
        q_in = rmsnorm(x, p.ln1)
        B = x.shape[0]
        KV, dh = cfg.n_kv_heads, cfg.d_head
        q = mm(q_in, p.attn.wq).reshape(B, 1, KV, cfg.n_heads // KV, dh)
        s = mm_f32(q, cache["k"], "bqkgd,bckd->bkgqc") * (dh ** -0.5)
        w = torch.softmax(s, dim=-1)
        o = mm_f32(w.to(cache["v"].dtype), cache["v"], "bkgqc,bckd->bqkgd")
        x = x + mm(o.to(x.dtype).reshape(B, 1, cfg.n_heads * dh), p.attn.wo)
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp), cache
    if kind == "mamba":
        y, new_c = mamba_decode(rmsnorm(x, p.ln1), p.mamba, cfg, cache,
                                exec_cfg)
        cache.update(new_c)
        return x + y, cache
    if kind == "rglru":
        y, new_c = rglru_decode(rmsnorm(x, p.ln1), p.rglru, cfg, cache,
                                exec_cfg)
        cache.update(new_c)
        x = x + y
        return x + mlp_block(rmsnorm(x, p.ln2), p.mlp), cache
    raise ValueError(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     kv_quant: bool = False, device=None):
    if kind in ("attn", "dense_attn", "moe"):
        window = cfg.window if cfg.kind == "hybrid" else 0
        return init_kv_cache(cfg, batch, max_len, window=window,
                             quant=kv_quant, device=device)
    if kind == "cross":
        shape = (batch, cfg.vision_tokens, cfg.n_kv_heads, cfg.d_head)
        dt = torch_dtype(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """The language model: ``prelude``, ``units`` and ``trailing`` block
    lists, ``ln_f``, ``head``, ``embed`` (or ``in_proj`` for precomputed
    frame embeddings) and ``smooth_taps`` when ``race_smooth_radius > 0``.
    Parameters are made with ``requires_grad=False`` (serving)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None, n_units_override: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        g, dev = generator, device
        dt = torch_dtype(cfg.dtype)
        nu = n_units(cfg) if n_units_override is None else n_units_override
        self.prelude = nn.ModuleList(Block(cfg, k, g, dev)
                                     for k in prelude_kinds(cfg))
        self.units = nn.ModuleList(Block(cfg, k, g, dev) for _ in range(nu)
                                   for k in unit_kinds(cfg))
        self.trailing = nn.ModuleList(Block(cfg, k, g, dev)
                                      for k in trailing_kinds(cfg))
        self.ln_f = param(init_rmsnorm(cfg.d_model, dev))
        self.head = param(dense_init(g, (cfg.d_model, cfg.vocab), dt,
                                     device=dev))
        if cfg.input_embed_dim:
            self.in_proj = param(dense_init(
                g, (cfg.input_embed_dim, cfg.d_model), dt, device=dev))
        else:
            self.embed = param(dense_init(g, (cfg.vocab, cfg.d_model), dt,
                                          device=dev))
        if cfg.race_smooth_radius:
            # zero taps: the RACE mixer starts as the identity residual
            self.smooth_taps = param(torch.zeros(
                (cfg.race_smooth_radius + 1,), dtype=torch.float32,
                device=dev))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def blocks(self):
        """(module, kind) for every layer, in order."""
        return [(b, b.kind) for part in (self.prelude, self.units,
                                          self.trailing) for b in part]


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                n_units_override: Optional[int] = None) -> LM:
    """A randomly initialized :class:`LM` on ``device`` (default ``cuda``;
    raises without a GPU).  ``generator`` draws every weight, on its own
    device, in the order the modules are built."""
    return LM(cfg, generator, resolve_device(device), n_units_override)


def _rope_cache(cfg: ModelConfig, max_pos: int, device):
    if cfg.kind in ("ssm",) or cfg.input_embed_dim:
        return None
    pos = torch.arange(max_pos, device=device)
    return rope_angles(pos, cfg.d_head, cfg.rope_theta)


def _on(t, device, dtype=None):
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=device, dtype=dtype)


def forward_hidden(params: LM, cfg: ModelConfig, exec_cfg: ExecConfig,
                   batch: dict, n_units_override: Optional[int] = None):
    """Final hidden states (B, S, D) after ``ln_f``.  ``batch`` holds
    ``tokens`` (B, S) or ``embeds`` (B, S, input_embed_dim), and ``vision``
    (B, vision_tokens, vision_dim) for vlm; numpy arrays or tensors, moved
    to the model's device.  With ``race_smooth_radius > 0`` the embedding
    goes through :func:`race_smooth` (K1 on the card) first."""
    dev = params.device
    if cfg.input_embed_dim:
        x = mm(_on(batch["embeds"], dev, torch_dtype(cfg.dtype)),
               params.in_proj)
    else:
        x = params.embed[_on(batch["tokens"], dev, torch.long)]
    if cfg.race_smooth_radius:
        x = x + race_smooth(x, params.smooth_taps,
                            radius=cfg.race_smooth_radius)
    S = x.shape[1]
    rope = _rope_cache(cfg, S, dev)
    vision = batch.get("vision")
    if vision is not None:
        vision = _on(vision, dev)
    for p, kind in params.blocks():
        x = apply_block(x, p, cfg, exec_cfg, kind, rope, vision)
    return rmsnorm(x, params.ln_f)


@torch.no_grad()
def prefill_logits(params: LM, cfg, exec_cfg, batch, n_units_override=None):
    """Inference prefill: next-token logits for the last position (B, V),
    float32."""
    h = forward_hidden(params, cfg, exec_cfg, batch, n_units_override)
    return mm(h[:, -1], params.head).float()


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                n_units_override: Optional[int] = None,
                kv_quant: bool = False, device=None) -> dict:
    """Decode state on ``device`` (default ``cuda``; raises without a GPU):
    ``{"prelude", "units", "trailing"}``, each a list of per-layer cache
    dicts in the order of :attr:`LM.prelude` / ``units`` / ``trailing``."""
    dev = resolve_device(device)
    nu = n_units(cfg) if n_units_override is None else n_units_override

    def caches(kinds):
        return [init_block_cache(cfg, k, batch, max_len, kv_quant, dev)
                for k in kinds]

    return {"prelude": caches(prelude_kinds(cfg)),
            "units": caches(unit_kinds(cfg) * nu),
            "trailing": caches(trailing_kinds(cfg))}


@torch.no_grad()
def decode_step(params: LM, caches: dict, cfg: ModelConfig,
                exec_cfg: ExecConfig, token, pos, rope_cache=None,
                max_len: int = 0):
    """One decode step.  token: (B, 1) ints; pos: the position (an int).
    Returns (logits (B, V) float32, caches), the caches updated in place."""
    dev = params.device
    x = params.embed[_on(token, dev, torch.long)]
    rope = rope_cache
    if rope is None and cfg.kind not in ("ssm",):
        rope = _rope_cache(cfg, max_len, dev)
    pos = int(pos)
    layer_caches = caches["prelude"] + caches["units"] + caches["trailing"]
    for (p, kind), c in zip(params.blocks(), layer_caches):
        x, _ = decode_block(x, p, cfg, exec_cfg, kind, c, pos, rope)
    h = rmsnorm(x, params.ln_f)
    return mm(h[:, 0], params.head).float(), caches
