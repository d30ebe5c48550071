"""Attention of the port (``repro/models/attention.py``): GQA with optional
qk-norm / qkv-bias / local window / cross attention; the reference's
doubly-chunked online-softmax forward (scores never exist beyond one
(cq, ck) tile) with its FlashAttention-2-style backward, and the
single-query decode path over a KV cache.

Layouts: q (B, S, KV, G, dh), k/v (B, S, KV, dh) with G = H / KV.  No
library attention call: this is the reference's algorithm, held against it
by ``tests/test_torch_models.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from .common import (ExecConfig, apply_rope, dense_init, init_rmsnorm, mm,
                     mm_f32, param, rmsnorm, torch_dtype)
from .config import ModelConfig

#: finite on purpose: a fully masked leading k-chunk of a windowed layer
#: gives exp(0) terms that the next chunk's corr = exp(NEG_INF - m) wipes
#: out; -inf would give NaN there
NEG_INF = -1e30


class Attention(nn.Module):
    """The projections of one attention layer (the reference's param dict:
    ``wq``, ``wk``, ``wv``, ``wo``, optional ``bq``/``bk``/``bv`` and
    ``q_norm``/``k_norm``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 cross: bool = False, device=None):
        super().__init__()
        D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        dt = torch_dtype(cfg.dtype)
        kv_in = cfg.vision_dim if cross else D
        g, dev = generator, device
        self.wq = param(dense_init(g, (D, H * dh), dt, device=dev))
        self.wk = param(dense_init(g, (kv_in, KV * dh), dt, device=dev))
        self.wv = param(dense_init(g, (kv_in, KV * dh), dt, device=dev))
        self.wo = param(dense_init(g, (H * dh, D), dt, device=dev))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((H * dh,), dtype=dt, device=dev))
            self.bk = param(torch.zeros((KV * dh,), dtype=dt, device=dev))
            self.bv = param(torch.zeros((KV * dh,), dtype=dt, device=dev))
        if cfg.qk_norm:
            self.q_norm = param(init_rmsnorm(dh, dev))
            self.k_norm = param(init_rmsnorm(dh, dev))


def init_attention(generator, cfg: ModelConfig, cross: bool = False,
                   device=None) -> Attention:
    return Attention(cfg, generator, cross, device)


def _project_qkv(x, kv_src, p: Attention, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = mm(x, p.wq)
    k = mm(kv_src, p.wk)
    v = mm(kv_src, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, KV, H // KV, dh)
    k = k.reshape(B, kv_src.shape[1], KV, dh)
    v = v.reshape(B, kv_src.shape[1], KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    return q, k, v


def _chunk_counts(S_q, S_k, exec_cfg: ExecConfig):
    if exec_cfg.unroll_scans:
        nq = min(exec_cfg.probe_chunks, S_q)
        nk = min(exec_cfg.probe_chunks, S_k)
    else:
        nq = max(1, S_q // max(1, min(exec_cfg.attn_chunk_q, S_q)))
        nk = max(1, S_k // max(1, min(exec_cfg.attn_chunk_k, S_k)))
    while S_q % nq:
        nq -= 1
    while S_k % nk:
        nk -= 1
    return nq, nk


def _tile_mask(pos_q, pos_k, causal: bool, window: int):
    mask = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                      device=pos_q.device)
    if causal:
        mask &= pos_k[None, :] <= pos_q[:, None]
    if window > 0:
        mask &= pos_k[None, :] > pos_q[:, None] - window
    return mask


def _flash_fwd(q, k, v, causal, window, exec_cfg, q_offset):
    """(out (B, Sq, KV, G, dh) in q's dtype, lse (B, Sq, KV, G) float32)."""
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    nq, nk = _chunk_counts(Sq, Sk, exec_cfg)
    cq, ck = Sq // nq, Sk // nk
    scale = dh ** -0.5
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        qc = q[:, iq * cq:(iq + 1) * cq]
        pos_q = q_offset + iq * cq + torch.arange(cq, device=dev)
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, cq, dh), dtype=torch.float32, device=dev)
        for ik in range(nk):
            kc = k[:, ik * ck:(ik + 1) * ck]
            vc = v[:, ik * ck:(ik + 1) * ck]
            pos_k = ik * ck + torch.arange(ck, device=dev)
            s = mm_f32(qc, kc, "bqkgd,bckd->bkgqc") * scale
            mask = _tile_mask(pos_q, pos_k, causal, window)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = mm_f32(p.to(vc.dtype), vc, "bkgqc,bckd->bkgqd")
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        lse = m + torch.log(torch.clamp(l, min=1e-30))  # (B, KV, G, cq)
        outs.append(o.permute(0, 3, 1, 2, 4))
        lses.append(lse.permute(0, 3, 1, 2))
    out = torch.cat(outs, dim=1)
    lse = torch.cat(lses, dim=1)
    return out.to(q.dtype), lse


def _flash_bwd(causal, window, exec_cfg, q_offset, res, dout):
    """The reference's FlashAttention-2-style backward: every (cq, ck) tile
    is recomputed from (q, k, v, lse), nothing tile-sized is kept across
    iterations.  A k-outer pass accumulates ``dk`` and ``dv``, a q-outer
    pass ``dq``, all in float32."""
    q, k, v, out, lse = res
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    nq, nk = _chunk_counts(Sq, Sk, exec_cfg)
    cq, ck = Sq // nq, Sk // nk
    scale = dh ** -0.5
    dev = q.device
    doutf = dout.float()
    D = (doutf * out.float()).sum(-1)  # (B, Sq, KV, G)

    def tile(iq, ik):
        """q chunk, dout chunk, k chunk, probabilities, score grads."""
        qs, ks = slice(iq * cq, (iq + 1) * cq), slice(ik * ck, (ik + 1) * ck)
        qc, doc, kc, vc = q[:, qs], doutf[:, qs], k[:, ks], v[:, ks]
        pos_q = q_offset + iq * cq + torch.arange(cq, device=dev)
        pos_k = ik * ck + torch.arange(ck, device=dev)
        s = mm_f32(qc, kc, "bqkgd,bckd->bkgqc") * scale
        mask = _tile_mask(pos_q, pos_k, causal, window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        p = torch.exp(s - lse[:, qs].permute(0, 2, 3, 1)[..., None])
        dp = mm_f32(doc, vc, "bqkgd,bckd->bkgqc")
        ds = p * (dp - D[:, qs].permute(0, 2, 3, 1)[..., None]) * scale
        return qc, doc, kc, p, ds

    dks, dvs = [], []
    for ik in range(nk):
        dk_acc = torch.zeros((B, ck, KV, dh), device=dev)
        dv_acc = torch.zeros((B, ck, KV, dh), device=dev)
        for iq in range(nq):
            qc, doc, _, p, ds = tile(iq, ik)
            dk_acc = dk_acc + mm_f32(ds, qc, "bkgqc,bqkgd->bckd")
            dv_acc = dv_acc + mm_f32(p, doc, "bkgqc,bqkgd->bckd")
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dqs = []
    for iq in range(nq):
        dq_acc = torch.zeros((B, cq, KV, G, dh), device=dev)
        for ik in range(nk):
            _, _, kc, _, ds = tile(iq, ik)
            dq_acc = dq_acc + mm_f32(ds, kc, "bkgqc,bckd->bqkgd")
        dqs.append(dq_acc)
    return (torch.cat(dqs, 1).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out,
    lse), the backward recomputes the tiles (:func:`_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, exec_cfg, q_offset):
        out, lse = _flash_fwd(q, k, v, causal, window, exec_cfg, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, exec_cfg, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal, window, exec_cfg, q_offset=0):
    """Online-softmax attention over (q-chunk, k-chunk) tiles with the
    reference's FA2-style hand-written backward (recompute, never store
    tiles).  Fully masked tiles are still computed, as in the reference."""
    return _FlashAttention.apply(q, k, v, causal, window, exec_cfg, q_offset)


def attention_block(x, p: Attention, cfg: ModelConfig, exec_cfg: ExecConfig,
                    rope_cache=None, kv_src=None, window: int = 0):
    """Full-sequence attention (train / prefill)."""
    B, S, D = x.shape
    cross = kv_src is not None
    q, k, v = _project_qkv(x, kv_src if cross else x, p, cfg)
    if rope_cache is not None and not cross:
        cos, sin = rope_cache
        q = apply_rope(q, cos[:S], sin[:S])
        k = apply_rope(k, cos[:S], sin[:S])
    out = flash_attention(q, k, v, cfg.causal and not cross, window, exec_cfg)
    return mm(out.reshape(B, S, cfg.n_heads * cfg.d_head), p.wo)


def _quantize_kv(t):
    """(B, 1, KV, dh) -> int8 values + per-(B,1,KV) scale (symmetric);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    tf = t.float()
    scale = tf.abs().amax(-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def decode_attention_block(x, p: Attention, cfg: ModelConfig, cache: dict,
                           pos: int, rope_cache=None, window: int = 0):
    """Single-token decode.  cache: {'k','v'}: (B, Smax, KV, dh), updated in
    place at slot ``pos`` (``pos % Smax``: a ring buffer for windowed
    layers).  With 'k_scale' in the cache the KV is int8-quantized."""
    B, S1, D = x.shape
    assert S1 == 1
    dh = cfg.d_head
    pos = int(pos)
    quant = "k_scale" in cache
    q, k, v = _project_qkv(x, x, p, cfg)
    if rope_cache is not None:
        cos, sin = rope_cache
        pc = cos[pos].expand(B, 1, dh // 2)
        ps = sin[pos].expand(B, 1, dh // 2)
        q = apply_rope(q, pc, ps)
        k = apply_rope(k, pc, ps)
    Smax = cache["k"].shape[1]
    # windowed layers use a ring buffer: slot i always holds one of the last
    # Smax positions (softmax is permutation-invariant and RoPE was applied
    # to k before caching, so ring order is harmless)
    slot = pos % Smax if window > 0 else pos
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_scale"][:, slot] = ks[:, 0]
        cache["v_scale"][:, slot] = vs[:, 0]
        k_eff = (cache["k"].to(torch.bfloat16)
                 * cache["k_scale"][..., None].to(torch.bfloat16))
        v_eff = (cache["v"].to(torch.bfloat16)
                 * cache["v_scale"][..., None].to(torch.bfloat16))
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        k_eff, v_eff = cache["k"], cache["v"]
    idx = torch.arange(Smax, device=x.device)
    if window > 0:
        valid = (idx <= slot) | (pos >= Smax)  # unwritten slots invalid
    else:
        valid = idx <= pos
    s = mm_f32(q, k_eff, "bqkgd,bckd->bkgqc") * (dh ** -0.5)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = mm_f32(pattn.to(v_eff.dtype), v_eff, "bkgqc,bckd->bqkgd")
    out = mm(o.to(x.dtype).reshape(B, 1, cfg.n_heads * dh), p.wo)
    return out, cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
                  quant: bool = False, device=None):
    n = min(window, max_len) if window > 0 else max_len
    shape = (batch, n, cfg.n_kv_heads, cfg.d_head)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
