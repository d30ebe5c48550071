"""Fused cross-entropy for the PyTorch port: the logits never reach memory.

Port of ``repro/kernels/fused_ce.py``.  :func:`fused_ce_forward` gives the
per-token loss ``lse(h @ w) - (h @ w)[label]`` in float32 for ``h (T, D)``
and ``w (D, V)`` (float32 or bfloat16, upcast to float32 before the
product; ``w`` row-major with ``V`` contiguous, the reference's layout) and
``labels (T,)`` int32.  The gold logit is found by comparing column indices
with the label, so a label outside ``[0, V)`` gives a gold logit of 0, as on
the TPU.  :func:`fused_ce` is the mean loss as a ``torch.autograd.Function``
whose backward recomputes the dense loss with autograd (:func:`_ce_ref`), as
the reference's ``custom_vjp`` recomputes through XLA.

On a CUDA tensor the forward launches the hand-written kernel of
``csrc/fused_ce.cu`` (which replaces the TPU kernel
``repro/kernels/fused_ce.py:_kernel``); on CPU tensors it runs
:func:`fused_ce_forward_ref`, the kernel's plain version, which follows the
kernel's split of the vocabulary and its combine.  Nothing falls back from
the card to the plain version.

The vocabulary is split because blocks on the card run in parallel: each
block takes ``TILE_T`` tokens and one vocab range (a split), keeps the
online-logsumexp state ``(m, l, g)`` of its range, and a second kernel
merges the splits per token.  What bounds it and what the design does about
it is in the source's header.
"""
from __future__ import annotations

import ctypes
from math import ceil

import torch

__all__ = ["KERNEL", "TILE_T", "TILE_V", "fused_ce", "fused_ce_forward",
           "fused_ce_forward_ref", "split_width"]

#: the kernel's tile: tokens per block and vocab columns per inner step
TILE_T = 64
TILE_V = 64
#: blocks the default split aims for: four for each of an H100 SXM's 132 SMs
TARGET_BLOCKS = 4 * 132
#: the launcher's dtype code is the position in this table
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SPLITS = 65535  # CUDA's limit on gridDim.y

_SYMBOLS = {
    "fused_ce_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "fused_ce_error": (ctypes.c_char_p, [ctypes.c_int]),
}


def split_width(T: int, V: int, v_blk=None) -> int:
    """Vocab columns per split, a multiple of ``TILE_V``.

    ``v_blk`` given: rounded up to a multiple of ``TILE_V``.  ``None``: as
    few columns as give the grid about ``TARGET_BLOCKS`` blocks.  The choice
    depends on the shapes alone, so the CPU and the card split alike."""
    n_vt = ceil(V / TILE_V)
    if v_blk is None:
        n_split = min(n_vt, max(1, ceil(TARGET_BLOCKS / ceil(T / TILE_T))))
        tiles = ceil(n_vt / n_split)
    else:
        if v_blk < 1:
            raise ValueError(f"v_blk must be positive, got {v_blk}")
        tiles = ceil(v_blk / TILE_V)
    return tiles * TILE_V


def _check(h, w, labels):
    if h.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"want h (T, D), w (D, V), labels (T,); got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    T, D = h.shape
    if w.shape[0] != D or labels.shape[0] != T:
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")
    if min(T, D, w.shape[1]) < 1:
        raise ValueError("T, D and V must be positive")
    if h.dtype != w.dtype or h.dtype not in KERNEL_DTYPES:
        raise ValueError(f"h and w must share one of {KERNEL_DTYPES}; got "
                         f"{h.dtype} and {w.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32, got {labels.dtype}")
    devices = {h.device, w.device, labels.device}
    if len(devices) != 1:
        raise ValueError(f"h, w and labels lie on several devices: {devices}")


def _combine(m, l, g):
    """Merge per-split partials ``(n_split, T)`` into the per-token loss, as
    ``fused_ce_combine_kernel`` does."""
    M = m.amax(0)
    L = (l * torch.exp(m - M)).sum(0)
    return M + torch.log(torch.clamp(L, min=1e-30)) - g.sum(0)


def fused_ce_forward_ref(h, w, labels, t_blk: int = 128, v_blk=None):
    """The kernel's plain version: per-split partials ``(m, l, g)`` over the
    same vocab ranges as the kernel, then the same combine, in float32.

    ``t_blk`` tokens are taken at a time, so the dense logits held at once
    are at most ``t_blk`` x the split width."""
    _check(h, w, labels)
    T, V = h.shape[0], w.shape[1]
    width = split_width(T, V, v_blk)
    out = torch.empty(T, dtype=torch.float32, device=h.device)
    for t0 in range(0, T, t_blk):
        hb = h[t0:t0 + t_blk].float()
        lab = labels[t0:t0 + t_blk, None].long()
        parts = []
        for v0 in range(0, V, width):
            z = hb @ w[:, v0:v0 + width].float()
            m = z.amax(1)
            cols = torch.arange(v0, v0 + z.shape[1], device=h.device)
            parts.append((m, torch.exp(z - m[:, None]).sum(1),
                          torch.where(cols == lab, z, 0.0).sum(1)))
        m, l, g = (torch.stack(p) for p in zip(*parts))
        out[t0:t0 + t_blk] = _combine(m, l, g)
    return out


class FusedCEKernel:
    """The wrapper of ``csrc/fused_ce.cu``.  ``launches`` counts its calls
    of the launcher (each runs the partial kernel and the combine)."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def __call__(self, h, w, labels, v_blk=None):
        _check(h, w, labels)
        dev = h.device
        if dev.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, not {dev}")
        for name, t in (("h", h), ("w", w), ("labels", labels)):
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
        (T, D), V = h.shape, w.shape[1]
        width = split_width(T, V, v_blk)
        n_split = ceil(V / width)
        if n_split > _MAX_SPLITS:
            raise ValueError(f"{n_split} vocab splits exceed {_MAX_SPLITS}; "
                             f"raise v_blk")
        if self._lib is None:
            from .build import csrc_source, load

            self._lib = load(csrc_source("fused_ce.cu"), _SYMBOLS)
        with torch.cuda.device(dev):
            part = torch.empty((3, n_split, T), dtype=torch.float32,
                               device=dev)
            loss = torch.empty(T, dtype=torch.float32, device=dev)
            rc = self._lib.fused_ce_launch(
                KERNEL_DTYPES.index(h.dtype), h.data_ptr(), w.data_ptr(),
                labels.data_ptr(), T, D, V, width, n_split, part.data_ptr(),
                loss.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = self._lib.fused_ce_error(rc).decode()
            raise RuntimeError(f"fused_ce kernel launch failed: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1
        return loss


KERNEL = FusedCEKernel()


def fused_ce_forward(h, w, labels, t_blk: int = 128, v_blk=None):
    """h: (T, D); w: (D, V); labels: (T,) int32 -> per-token loss (T,) f32.

    The keyword arguments keep the reference's names.  ``v_blk`` is the
    vocab range of one split (rounded up to a multiple of ``TILE_V``;
    ``None`` chooses it to fill the card); unlike the reference's, it need
    not divide ``V``: the ragged edge is masked.  ``t_blk`` bounds the
    tokens the plain version takes at a time; the kernel's token tile is
    fixed at ``TILE_T``.  Neither changes the result beyond rounding.  The
    reference's ``interpret`` has no counterpart: the tensors' device
    decides."""
    if h.device.type == "cpu":
        return fused_ce_forward_ref(h, w, labels, t_blk, v_blk)
    return KERNEL(h, w, labels, v_blk)


def _ce_ref(h, w, labels):
    """Dense mean loss: ``logsumexp(h @ w) - (h @ w)[label]`` in float32."""
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None].long())[:, 0]
    return (lse - gold).mean()


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, t_blk, v_blk):
        ctx.save_for_backward(h, w, labels)
        return fused_ce_forward(h, w, labels, t_blk, v_blk).mean()

    @staticmethod
    def backward(ctx, g):
        # the reference recomputes through XLA; here the dense loss is
        # recomputed with autograd (its product goes to torch.matmul)
        h, w, labels = ctx.saved_tensors
        with torch.enable_grad():
            hd, wd = h.detach().requires_grad_(), w.detach().requires_grad_()
            dh, dw = torch.autograd.grad(_ce_ref(hd, wd, labels), (hd, wd))
        return (dh * g).to(h.dtype), (dw * g).to(w.dtype), None, None, None


def fused_ce(h, w, labels, t_blk: int = 128, v_blk=None):
    """Mean cross-entropy with the fused forward; differentiable in ``h``
    and ``w``.  The backward recomputes the dense loss (:func:`_ce_ref`)."""
    return _FusedCE.apply(h, w, labels, t_blk, v_blk)
