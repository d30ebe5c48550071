"""Shared model components of the port (``repro/models/common.py``): the
execution knobs, RMSNorm, RoPE, the initializer and the device and dtype
helpers every block uses.

The reference's vocab-chunked loss (``chunked_ce_loss``) belongs to the
training path, which is not ported yet (ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import ModelConfig


@dataclass(frozen=True)
class ExecConfig:
    """Execution knobs, with the reference's fields and defaults.

    ``unroll_scans`` keeps the reference's chunk-count semantics: the
    attention, SSM and MoE loops take ``probe_chunks`` chunks instead of
    fixed chunk sizes.  ``remat`` and ``remat_policy`` are training knobs
    and the forward pass ignores them.  ``mesh`` must stay ``None``: the
    activation sharding of ``models/sharding.py`` is not ported yet
    (ROADMAP Queue 1, item 9), so :meth:`constrain` is the identity."""

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
                "ExecConfig(mesh=...): activation sharding "
                "(repro/models/sharding.py) is not ported yet (ROADMAP "
                "Queue 1, item 9); the port's LM runs on one device")

    def constrain(self, x, *spec):
        return x

    def batch_axes(self) -> tuple:
        return ()


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


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
    device, then cast and moved to ``device``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    std = scale / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(device=device, dtype=dtype)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)
