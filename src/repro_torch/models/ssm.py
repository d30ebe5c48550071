"""Recurrent sequence mixers of the port (``repro/models/ssm.py``): Mamba-1's
selective SSM, Griffin's RG-LRU, and the RACE-optimized causal FIR mixer.

Both recurrences have the diagonal affine form  h_t = a_t * h_{t-1} + b_t,
solved inside fixed-size time chunks by a log-depth (Hillis-Steele) scan
over the chunk's time axis, with a Python loop carrying the state across
chunks: the (B, chunk, d_inner, N) discretization of Mamba exists one
chunk at a time, as in the reference.  (Torch has no public associative
scan, and a loop over time would launch S kernels per layer on the card.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.executor import default_backend
from .common import (ExecConfig, dense_init, mm, param, sigmoid, silu,
                     torch_dtype)
from .config import ModelConfig


def _n_chunks(S: int, exec_cfg: ExecConfig) -> int:
    if exec_cfg.unroll_scans:
        n = min(exec_cfg.probe_chunks, S)
    else:
        n = max(1, S // max(1, min(exec_cfg.ssm_chunk, S)))
    while S % n:
        n -= 1
    return n


def _chunked(x, n):
    """(B, S, ...) -> n chunks of (B, S/n, ...)"""
    return x.chunk(n, dim=1)


def _scan_recurrence(h0, chunk_fn, xs, exec_cfg: ExecConfig, S: int):
    """Carry h across time chunks.  ``chunk_fn(h, *xs_chunk) -> (y_chunk,
    h_last)``; xs are (B, S, ...) tensors chunked along time."""
    n = _n_chunks(S, exec_cfg)
    ys, h = [], h0
    for xc in zip(*(_chunked(x, n) for x in xs)):
        y, h = chunk_fn(h, *xc)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _assoc(a, b, h0):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t within one chunk (axis 1),
    h0 folded into b_0; log2(chunk) steps of the reference's combine
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)."""
    b = torch.cat([(b[:, :1] + a[:, :1] * h0[:, None]), b[:, 1:]], dim=1)
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  With ``state``
    ((B, K-1, C), decode) returns (y, new_state)."""
    K = w.shape[0]
    if state is not None:
        buf = torch.cat([state, x], dim=1)  # (B, K-1+S, C)
        new_state = buf[:, -(K - 1):]
        y = sum(buf[:, i:i + x.shape[1]] * w[i] for i in range(K))
        return y, new_state
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return y, None


# ---------------------------------------------------------------------------
# RACE-optimized causal FIR mixer
# ---------------------------------------------------------------------------

#: memoized RACE results per (seq_len, channels, radius): detection and
#: planning run once per shape; every prefill reuses the compiled executor
_smooth_results: dict = {}


def _smooth_result(S: int, C: int, R: int):
    """The mixer's RACE result for an (S + R + 2, C) stream: the reference's
    program, through the port's ``race(..., reassociate=3)``."""
    key = (S, C, R)
    res = _smooth_results.get(key)
    if res is None:
        from ..core.ir import Scalar, arr, loopnest, program
        from ..core.race import race

        loops, (s, c) = loopnest(("s", 0, S - 1), ("c", 0, C - 1))
        xs, ys = arr("sx"), arr("sy")

        def box(t):  # the 3-point partial sum RACE detects and reuses
            return (xs[t, c] + xs[t + 1, c]) + xs[t + 2, c]

        expr = Scalar("sw0") * box(s + R)
        for d in range(1, R + 1):
            expr = expr + Scalar(f"sw{d}") * box(s + R - d)
        res = _smooth_results[key] = race(program(loops, [(ys[s, c], expr)]),
                                          reassociate=3)
    return res


def smooth_env(x, taps, radius: int) -> dict:
    """The mixer's env for x (B, S, C): ``sx`` the left-padded stream as
    (S + R + 2, B*C) float32, ``sy`` zeros (S, B*C), ``sw{d}`` the taps."""
    B, S, C = x.shape
    R = int(radius)
    P = R + 2  # left pad: deepest reach of box(s + R - R) .. box(s + R) + 2
    xp = F.pad(x.float(), (0, 0, P, 0))
    env = {"sx": xp.transpose(0, 1).reshape(S + P, B * C).contiguous(),
           "sy": torch.zeros((S, B * C), dtype=torch.float32,
                             device=x.device)}
    for d in range(R + 1):
        env[f"sw{d}"] = taps[d].float()
    return env


def race_smooth(x, taps, *, radius: int, backend=None):
    """Causal FIR residual mixer over the token stream, computed through the
    RACE pipeline: ``y[s] = sum_d taps[d] * b(s + R - d)`` with ``b(t)`` a
    3-point box sum of the left-padded stream, whose shared box sums RACE
    finds and computes once (one aux).

    ``backend`` (``None``: ``$RACE_BACKEND`` or ``"auto"``) goes to the
    executor: ``"auto"`` runs the plan on K1 (the CUDA stencil kernel) for a
    CUDA tensor and on the kernel's tile emulator on the CPU; ``"torch"``
    runs the whole-array evaluator.  x: (B, S, C); taps: (radius+1,)."""
    B, S, C = x.shape
    res = _smooth_result(S, B * C, int(radius))
    # resolved per call: the memoized result keeps the backend of its build
    y = res.run(smooth_env(x, taps, radius), backend or default_backend(),
                device=x.device)["sy"]
    return y.reshape(S, B, C).transpose(0, 1).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        D, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.ssm_conv)
        dt = torch_dtype(cfg.dtype)
        g, dev = generator, device
        self.in_proj = param(dense_init(g, (D, 2 * di), dt, device=dev))
        self.conv_w = param(dense_init(g, (K, di), dt, scale=3.0, device=dev))
        self.x_proj = param(dense_init(g, (di, R + 2 * N), dt, device=dev))
        self.dt_proj = param(dense_init(g, (R, di), dt, device=dev))
        # softplus(-4) ~ 0.018
        self.dt_bias = param(torch.full((di,), -4.0, device=dev))
        self.A_log = param(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev)).expand(di, N).clone())
        self.D_skip = param(torch.ones((di,), device=dev))
        self.out_proj = param(dense_init(g, (di, D), dt, device=dev))


def init_mamba(generator, cfg: ModelConfig, device=None) -> Mamba:
    return Mamba(cfg, generator, device)


def _mamba_core(xz, p: Mamba, cfg: ModelConfig, conv_state, h0, exec_cfg):
    """Shared prefill/decode core.  xz: (B, S, 2*di).  The (B, C, di, N)
    discretization lives only inside the chunk body."""
    N = cfg.ssm_state
    S = xz.shape[1]
    xin, z = xz.chunk(2, dim=-1)
    xc, new_conv = _causal_conv1d(xin, p.conv_w, conv_state)
    xc = silu(xc)
    proj = mm(xc, p.x_proj)
    dt_low, Bm, Cm = torch.split(proj, [cfg.dt_rank, N, N], dim=-1)
    dt = F.softplus(mm(dt_low, p.dt_proj).float() + p.dt_bias)
    A = -torch.exp(p.A_log)  # (di, N)

    def chunk_fn(h, dt_c, Bm_c, Cm_c, x_c):
        dA = torch.exp(dt_c[..., None] * A)                      # (B,C,di,N)
        dBx = (dt_c * x_c)[..., None] * Bm_c[..., None, :].float()
        hs = _assoc(dA, dBx, h)
        y = torch.einsum("bsdn,bsn->bsd", hs, Cm_c.float())
        return y, hs[:, -1]

    y, h_last = _scan_recurrence(h0, chunk_fn, (dt, Bm, Cm, xc.float()),
                                 exec_cfg, S)
    if getattr(exec_cfg, "ssm_bf16", False):
        y = y.to(xz.dtype) + p.D_skip.to(xz.dtype) * xc
        y = y * silu(z)
    else:
        y = y + p.D_skip * xc.float()
        y = (y * silu(z.float())).to(xz.dtype)
    return mm(y, p.out_proj), new_conv, h_last


def mamba_block(x, p: Mamba, cfg: ModelConfig, exec_cfg: ExecConfig):
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    y, _, _ = _mamba_core(mm(x, p.in_proj), p, cfg, None, h0, exec_cfg)
    return y


def mamba_decode(x, p: Mamba, cfg: ModelConfig, cache: dict,
                 exec_cfg: ExecConfig):
    """x: (B, 1, D); cache: {'conv': (B, K-1, di), 'h': (B, di, N)}."""
    y, new_conv, h_last = _mamba_core(
        mm(x, p.in_proj), p, cfg, cache["conv"], cache["h"], exec_cfg)
    return y, {"conv": new_conv, "h": h_last}


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

_LRU_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        D = cfg.d_model
        W = cfg.lru_width or D
        K = cfg.ssm_conv
        dt = torch_dtype(cfg.dtype)
        g, dev = generator, device
        self.in_proj = param(dense_init(g, (D, 2 * W), dt, device=dev))
        self.conv_w = param(dense_init(g, (K, W), dt, scale=3.0, device=dev))
        self.w_input_gate = param(dense_init(g, (W, W), dt, device=dev))
        self.w_rec_gate = param(dense_init(g, (W, W), dt, device=dev))
        # a ~ exp(-8 * sigmoid(r) * softplus(lambda))
        self.lambda_p = param(torch.full((W,), 2.0, device=dev))
        self.out_proj = param(dense_init(g, (W, D), dt, device=dev))


def init_rglru(generator, cfg: ModelConfig, device=None) -> RGLRU:
    return RGLRU(cfg, generator, device)


def _rglru_core(x2, p: RGLRU, cfg: ModelConfig, conv_state, h0, exec_cfg):
    S = x2.shape[1]
    x_br, gate_br = x2.chunk(2, dim=-1)
    xc, new_conv = _causal_conv1d(x_br, p.conv_w, conv_state)
    i_t = sigmoid(mm(xc, p.w_input_gate).float())
    r_t = sigmoid(mm(xc, p.w_rec_gate).float())
    log_a = -_LRU_C * r_t * F.softplus(p.lambda_p)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i_t * xc.float())

    def chunk_fn(h, a_c, b_c):
        hs = _assoc(a_c, b_c, h)
        return hs, hs[:, -1]

    h, h_last = _scan_recurrence(h0, chunk_fn, (a, b), exec_cfg, S)
    # jax.nn.gelu's default is the tanh approximation
    y = (h * F.gelu(gate_br.float(), approximate="tanh")).to(x2.dtype)
    return mm(y, p.out_proj), new_conv, h_last


def rglru_block(x, p: RGLRU, cfg: ModelConfig, exec_cfg: ExecConfig):
    W = cfg.lru_width or cfg.d_model
    h0 = torch.zeros((x.shape[0], W), dtype=torch.float32, device=x.device)
    y, _, _ = _rglru_core(mm(x, p.in_proj), p, cfg, None, h0, exec_cfg)
    return y


def rglru_decode(x, p: RGLRU, cfg: ModelConfig, cache: dict,
                 exec_cfg: ExecConfig):
    y, new_conv, h_last = _rglru_core(
        mm(x, p.in_proj), p, cfg, cache["conv"], cache["h"], exec_cfg)
    return y, {"conv": new_conv, "h": h_last}


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None):
    W = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, W),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
    }
