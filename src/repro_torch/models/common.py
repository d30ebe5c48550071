"""Shared model components of the port (``repro/models/common.py``): the
execution knobs, RMSNorm, RoPE, the initializer, the device and dtype
helpers every block uses, and the vocab-chunked training loss
:func:`chunked_ce_loss`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig


@dataclass(frozen=True)
class ExecConfig:
    """Execution knobs, with the reference's fields and defaults.

    ``unroll_scans`` keeps the reference's chunk-count semantics: the
    attention, SSM, MoE and loss loops take ``probe_chunks`` chunks instead
    of fixed chunk sizes.  ``remat`` and ``remat_policy`` act where autograd
    records (training): each layer unit's activations are recomputed in the
    backward pass, ``"dots"`` keeping its matrix products' outputs.
    ``mesh`` must stay ``None``: the port's sharding rules and placement
    (:mod:`.sharding`) exist, but running the model on a mesh is the next
    slice (ROADMAP Queue 1, item 9.3's second half), so :meth:`constrain`
    is the identity."""

    unroll_scans: bool = False
    probe_chunks: int = 2      # chunk count in unrolled (probe) mode
    attn_chunk_q: int = 256
    attn_chunk_k: int = 1024
    ssm_chunk: int = 256
    loss_chunk: int = 512
    remat: bool = True
    mesh: object = None
    seq_parallel: bool = True
    logits_dtype: str = "float32"
    remat_policy: str = "nothing"
    kv_quant: bool = False          # int8 KV cache for decode
    moe_chunk: int = 65536          # tokens per MoE dispatch chunk
    ssm_pin: bool = True
    ssm_bf16: bool = False          # bf16 post-scan gating chain

    def __post_init__(self):
        if self.mesh is not None:
            raise ValueError(
                "ExecConfig(mesh=...): running the LM on a mesh is the "
                "port's next slice (ROADMAP Queue 1, item 9.3's second "
                "half: single-controller mesh execution); models/sharding.py"
                "'s specs and placement are ported, and the LM runs on one "
                "device")

    def constrain(self, x, *spec):
        return x

    def batch_axes(self) -> tuple:
        return ()


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def to_device(t, device, dtype=None) -> torch.Tensor:
    """``t`` (a tensor, numpy array or nested list) on ``device``."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=device, dtype=dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's type promotion (float32 @ bfloat16 is float32;
    torch refuses mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def mm_f32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=float32)``: the
    operands' exact products summed in float32."""
    return torch.einsum(eq, a.float(), b.float())


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``, each
    operation in x's dtype.  In bfloat16 ``torch.sigmoid`` rounds once
    and differs from it on about a sixth of all inputs."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)`` with :func:`sigmoid`."""
    return x * sigmoid(x)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_rmsnorm(d: int, device=None):
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions, d_head: int, theta: float):
    """cos and sin of ``angles[p, i] = p * theta^(-2i/d)`` in float32: the
    frequencies in numpy float64, then the product in float32, as the
    reference computes them."""
    half = d_head // 2
    freqs = theta ** (-np.arange(0, half) * 2.0 / d_head)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    ang = positions.float()[..., None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, ..., d_head) with sequence at axis 1 and head dim last;
    cos/sin: (S, d_head/2) shared across rows, or (B, S, d_head/2)."""
    half = x.shape[-1] // 2
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    shape[-1] = half
    if cos.ndim == 3:  # (B, S, half)
        shape[0] = x.shape[0]
    cos = cos.reshape(shape)
    sin = sin.reshape(shape)
    xf = x.float()
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, scale: float = 1.0,
               device=None):
    """Normal(0, scale^2 / fan_in) drawn in float32 on the generator's
    device, then cast and moved to ``device``.  On the meta device nothing
    is drawn (the generator may be None): a tensor of the shape and dtype
    only, as ``jax.eval_shape`` of the initializer gives."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    std = scale / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(device=device, dtype=dtype)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A frozen parameter (serving needs no grads);
    ``init_params(..., trainable=True)`` makes a whole model trainable."""
    return torch.nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# loss (vocab-chunked cross-entropy; the logits never fully materialize)
# ---------------------------------------------------------------------------


def _ce_chunk(hc, w, lc, mc, logits_dtype):
    """Summed masked cross-entropy of one sequence chunk: the (B, C, V)
    logits as ``einsum(..., preferred_element_type=logits_dtype)`` gives
    them (exact products summed in float32, then that dtype), reduced in
    float32."""
    logits = mm_f32(hc, w, "bcd,dv->bcv").to(logits_dtype).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return ((lse - gold) * mc).sum()


def chunked_ce_loss(h, w_out, labels, exec_cfg: ExecConfig, mask=None):
    """h: (B, S, D); w_out: (D, V); labels: (B, S) ints (numpy or tensor).
    The mean cross-entropy over unmasked tokens, taken over sequence chunks
    with the reference's chunk count, so the (B, S, V) logits never exist:
    where autograd records, each chunk's logits are recomputed in the
    backward pass (non-reentrant ``torch.utils.checkpoint``), never stored.
    The loss sum and the count accumulate in float32."""
    B, S, D = h.shape
    if exec_cfg.unroll_scans:
        n_chunks = min(exec_cfg.probe_chunks, S)
    else:
        n_chunks = max(1, S // max(1, min(exec_cfg.loss_chunk, S)))
    while S % n_chunks:
        n_chunks -= 1
    C = S // n_chunks
    labels = to_device(labels, h.device, torch.long)
    mask = (torch.ones(labels.shape, device=h.device) if mask is None
            else to_device(mask, h.device, torch.float32))
    w = w_out.float()  # once, not per chunk: the cast is what the chunks share
    dt = torch_dtype(exec_cfg.logits_dtype)
    loss_sum = cnt = torch.zeros((), device=h.device)
    for i in range(n_chunks):
        sl = slice(i * C, (i + 1) * C)
        args = (h[:, sl], w, labels[:, sl], mask[:, sl], dt)
        part = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _ce_chunk(*args))
        loss_sum = loss_sum + part
        cnt = cnt + mask[:, sl].sum()
    return loss_sum / torch.clamp(cnt, min=1.0)
