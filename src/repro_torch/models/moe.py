"""SwiGLU MLP and Mixture-of-Experts of the port (``repro/models/moe.py``).

Tokens are top-k routed, flattened to (tokens*k) and sorted by expert id
(a stable sort, as ``jnp.argsort``, so the same tokens overflow); then
either bucketed into (E, C, D) expert buffers (``"capacity"``) or run
expert by expert over the sorted rows (``"ragged"``, the counterpart of
``lax.ragged_dot``), and combined with the gate weights by a scatter-add.

``"capacity"`` departs from the reference in one place (ROADMAP F8): only
the kept tokens (``within < C``) are written into the expert buffer, so
every kept token gets its expert's output, as GShard's semantics say.  The
reference also scatters the dropped tokens' zeros to slot ``C-1``, where
the last write wins on XLA:CPU and wipes the token kept there.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .common import dense_init, mm, param, silu, torch_dtype
from .config import ModelConfig


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, d_ff: int = 0,
                 device=None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        self.w_gate = param(dense_init(generator, (D, Fd), dt, device=device))
        self.w_up = param(dense_init(generator, (D, Fd), dt, device=device))
        self.w_down = param(dense_init(generator, (Fd, D), dt, device=device))


def init_mlp(generator, cfg: ModelConfig, d_ff: int = 0, device=None) -> MLP:
    return MLP(cfg, generator, d_ff, device)


def mlp_block(x, p: MLP):
    g = mm(x, p.w_gate)
    u = mm(x, p.w_up)
    return mm(silu(g) * u, p.w_down)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
        dt = torch_dtype(cfg.dtype)
        g = generator
        self.router = param(dense_init(g, (D, E), torch.float32,
                                       device=device))
        self.w_gate = param(dense_init(g, (E, D, Fd), dt, device=device))
        self.w_up = param(dense_init(g, (E, D, Fd), dt, device=device))
        self.w_down = param(dense_init(g, (E, Fd, D), dt, device=device))
        if cfg.moe_shared:
            self.shared = MLP(cfg, g, cfg.moe_shared * Fd, device)


def init_moe(generator, cfg: ModelConfig, device=None) -> MoE:
    return MoE(cfg, generator, device)


def _route(x, p: MoE, cfg: ModelConfig):
    B, S, D = x.shape
    K = cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, D)
    logits = xf.float() @ p.router
    # lax.top_k: the K largest, ties to the lower index (a stable sort)
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :K], top_idx[:, :K]
    gates = torch.softmax(top_vals, dim=-1)
    expert_flat = top_idx.reshape(T * K)
    token_flat = torch.arange(T, device=x.device).repeat_interleave(K)
    gate_flat = gates.reshape(T * K)
    order = torch.argsort(expert_flat, stable=True)
    return xf, expert_flat, token_flat, gate_flat, order


def moe_block(x, p: MoE, cfg: ModelConfig, impl: str = "capacity",
              exec_cfg=None):
    """x: (B, S, D) -> (B, S, D); ``impl`` ``"capacity"`` (expert buffers
    of C = T*K*capacity/E rows, overflow drops) or ``"ragged"`` (no
    dropping).  ``exec_cfg.moe_chunk`` bounds the tokens per dispatch
    (capacity becomes per chunk), as in the reference."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S

    chunk = getattr(exec_cfg, "moe_chunk", 0) if exec_cfg is not None else 0
    if exec_cfg is not None and exec_cfg.unroll_scans:
        n_chunks = min(exec_cfg.probe_chunks, T)
        while T % n_chunks:
            n_chunks -= 1
    elif chunk and T > chunk:
        n_chunks = T // chunk
        while T % n_chunks:
            n_chunks -= 1
    else:
        n_chunks = 1
    if n_chunks > 1:
        sub = dataclasses.replace(exec_cfg, moe_chunk=0, unroll_scans=False)
        xc = x.reshape(n_chunks, 1, T // n_chunks, D)
        out = torch.stack([moe_block(xc[i], p, cfg, impl=impl, exec_cfg=sub)
                           for i in range(n_chunks)])
        # shared experts were computed per chunk inside the recursion
        return out.reshape(B, S, D)

    xf, expert_flat, token_flat, gate_flat, order = _route(x, p, cfg)
    tok = token_flat[order]

    if impl == "ragged":
        xs = xf[tok]
        sizes = torch.bincount(expert_flat, minlength=E).tolist()
        ys, start = [], 0
        for e, n in enumerate(sizes):
            rows = xs[start:start + n]
            h = silu(mm(rows, p.w_gate[e])) * mm(rows, p.w_up[e])
            ys.append(mm(h, p.w_down[e]))
            start += n
        y = torch.cat(ys)
        y = y * gate_flat[order][:, None].to(y.dtype)
        out = torch.zeros((T, D), dtype=y.dtype, device=x.device)
        out.index_add_(0, tok, y)
    else:
        C = max(8, int(T * K * cfg.moe_capacity) // E)
        se = expert_flat[order]
        group_sizes = torch.bincount(expert_flat, minlength=E)
        group_start = torch.cumsum(group_sizes, 0) - group_sizes
        within = torch.arange(T * K, device=x.device) - group_start[se]
        keep = within < C
        slot = torch.clamp(within, 0, C - 1)
        buf = torch.zeros((E, C, D), dtype=xf.dtype, device=x.device)
        buf[se[keep], within[keep]] = xf[tok[keep]]
        g = mm(buf, p.w_gate)
        u = mm(buf, p.w_up)
        h = silu(g) * u
        y = mm(h, p.w_down)
        y_tok = y[se, slot] * (gate_flat[order] * keep)[:, None].to(y.dtype)
        out = torch.zeros((T, D), dtype=y.dtype, device=x.device)
        out.index_add_(0, tok, y_tok)

    if cfg.moe_shared:
        out = out + mlp_block(xf, p.shared)
    return out.reshape(B, S, D).to(x.dtype)
