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

On a CUDA tensor the forward launches hand-written kernels of
``csrc/fused_ce.cu`` (which replace the TPU kernel
``repro/kernels/fused_ce.py:_kernel``); on CPU tensors it runs
:func:`fused_ce_forward_ref`, the kernels' plain version, which follows the
kernel's split of the vocabulary and its combine.  Nothing falls back from
the card to the plain version.

Three kernels, chosen by :func:`variant` before launch from dtype, shapes
and pointer alignment alone: ``"wgmma"`` (tensor cores, operands loaded by
TMA) for bfloat16 operands TMA can describe; ``"tf32x3"`` (tensor cores,
3xTF32) for every float32 input, after a pre-pass (:func:`tf32_split`) that
splits ``h`` and ``w`` into TF32 parts ``hi + lo`` laid out for TMA, ``w``
transposed; ``"ffma"`` (CUDA cores) for bfloat16 that TMA cannot describe
(a row of ``h`` or ``w`` that is no multiple of 16 bytes, a base pointer
off 16 bytes).  A failed build or launch of any raises.

The vocabulary is split because blocks on the card run in parallel: each
block takes a tile of tokens and one vocab range (a split), keeps the
online-logsumexp state ``(m, l, g)`` of its range, and a second kernel
merges the splits per token.  What bounds it and what the design does about
it is in the source's header.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from math import ceil

import torch

__all__ = ["KERNEL", "TILES", "fused_ce", "fused_ce_forward",
           "fused_ce_forward_ref", "fused_ce_partials_ref", "split_width",
           "tf32_split", "tf32_split_ref", "variant"]

#: each kernel's tile: tokens per block, vocab columns per inner step
TILES = {"wgmma": (128, 256), "tf32x3": (128, 192), "ffma": (64, 64)}
#: blocks of each kernel that one SM holds at once (a tensor-core block
#: takes 384 threads of 168 registers, and a 193 KB or 161 KB ring)
BLOCKS_PER_SM = {"wgmma": 1, "tf32x3": 1, "ffma": 4}
#: an H100 SXM's streaming multiprocessors
SMS = 132
#: a block's fixed cost (filling its pipeline, writing its partials) in
#: units of one vocab tile, for the split's makespan model
FILL_TILES = 0.25
#: the dtypes ``h`` and ``w`` may share
DTYPES = (torch.float32, torch.bfloat16)
_MAX_SPLITS = 65535  # CUDA's limit on gridDim.y
#: TMA's alignment of base pointers and row strides, in bytes
_TMA_ALIGN = 16

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_SYMBOLS = {
    "fused_ce_launch": (ctypes.c_int, _ARGS),
    "fused_ce_wgmma_launch": (ctypes.c_int, _ARGS),
    # h_hi, h_lo, w_hi, w_lo, their row pitch, then _ARGS from labels on
    "fused_ce_tf32x3_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                               + [ctypes.c_int, *_ARGS[2:]]),
    "fused_ce_split_launch": (ctypes.c_int,
                              [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p]),
    "fused_ce_error": (ctypes.c_char_p, [ctypes.c_int]),
}


def variant(h, w) -> str:
    """The kernel that takes ``h (T, D)`` and ``w (D, V)``: ``"tf32x3"`` for
    float32 (its pre-pass writes padded, aligned operands, so every float32
    input can take it); for bfloat16, ``"wgmma"`` where the base pointers
    are 16-byte aligned and the rows (``2*D`` and ``2*V`` bytes) multiples
    of 16 bytes, which TMA can describe, ``"ffma"`` otherwise.  A pure
    function of dtype, shapes and alignment, so the CPU (where it sets the
    plain version's split) and the card agree on it."""
    if h.dtype == torch.float32:
        return "tf32x3"
    size = h.element_size()
    aligned = all(t.data_ptr() % _TMA_ALIGN == 0 for t in (h, w))
    rows = all(n * size % _TMA_ALIGN == 0 for n in (h.shape[1], w.shape[1]))
    return "wgmma" if aligned and rows else "ffma"


def split_width(T: int, V: int, v_blk=None, *, variant: str) -> int:
    """Vocab columns per split for ``variant``'s kernel, a multiple of its
    tile width.

    ``v_blk`` given: rounded up to a multiple of the tile width.  ``None``:
    the tiles per split that give the least makespan when the blocks run
    in waves of ``SMS * BLOCKS_PER_SM`` (waves x (tiles + ``FILL_TILES``)),
    the fewest splits among equals; a whole number of waves where the
    shape allows (at T=4096, V=152064 on ``"wgmma"``: 32 token tiles x 33
    splits = 8 waves of 132).  The choice depends on the shapes alone, so
    the CPU and the card split alike."""
    tile_t, tile_v = TILES[variant]
    if v_blk is not None:
        if v_blk < 1:
            raise ValueError(f"v_blk must be positive, got {v_blk}")
        return ceil(v_blk / tile_v) * tile_v
    n_tt, n_vt = ceil(T / tile_t), ceil(V / tile_v)
    return _tiles_per_split(n_tt, n_vt, SMS * BLOCKS_PER_SM[variant]) * tile_v


@lru_cache(maxsize=256)
def _tiles_per_split(n_tt: int, n_vt: int, wave: int) -> int:
    """The search of :func:`split_width`, kept per shape: it runs on every
    launch, between the caller's work and the kernel."""
    def makespan(tiles):
        n_split = ceil(n_vt / tiles)
        if n_split > _MAX_SPLITS:
            return float("inf")
        return ceil(n_tt * n_split / wave) * (tiles + FILL_TILES)

    return min(range(n_vt, 0, -1), key=makespan)


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
    if h.dtype != w.dtype or h.dtype not in DTYPES:
        raise ValueError(f"h and w must share one of {DTYPES}; got "
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


def fused_ce_partials_ref(h, w, labels, t_blk: int = 128, v_blk=None):
    """The partial kernels' plain version: ``(m, l, g)``, each
    ``(n_split, T)`` float32, over the vocab ranges the kernel of
    :func:`variant` takes.  ``t_blk`` tokens are taken at a time, so the
    dense logits held at once are at most ``t_blk`` x the split width."""
    _check(h, w, labels)
    T, V = h.shape[0], w.shape[1]
    width = split_width(T, V, v_blk, variant=variant(h, w))
    n_split = ceil(V / width)
    m, l, g = torch.empty((3, n_split, T), dtype=torch.float32,
                          device=h.device)
    for t0 in range(0, T, t_blk):
        hb = h[t0:t0 + t_blk].float()
        lab = labels[t0:t0 + t_blk, None].long()
        for s, v0 in enumerate(range(0, V, width)):
            z = hb @ w[:, v0:v0 + width].float()
            mz = z.amax(1)
            cols = torch.arange(v0, v0 + z.shape[1], device=h.device)
            m[s, t0:t0 + t_blk] = mz
            l[s, t0:t0 + t_blk] = torch.exp(z - mz[:, None]).sum(1)
            g[s, t0:t0 + t_blk] = torch.where(cols == lab, z, 0.0).sum(1)
    return m, l, g


def fused_ce_forward_ref(h, w, labels, t_blk: int = 128, v_blk=None):
    """The kernels' plain version: per-split partials ``(m, l, g)`` over the
    same vocab ranges as the kernel (:func:`fused_ce_partials_ref`), then
    the same combine, in float32."""
    return _combine(*fused_ce_partials_ref(h, w, labels, t_blk, v_blk))


def _round_tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, on the bit pattern; inf and NaN are left alone."""
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def _pitch(n: int) -> int:
    """``n`` floats rounded up to a 16-byte row, as TMA needs."""
    return -(-n // 4) * 4


def tf32_split_ref(x, transpose: bool = False):
    """The pre-pass's plain version.  ``x (R, C)`` float32 -> ``(2, R,
    Cp)``: ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``, float32 bit
    patterns whose low 13 bits are zero, with ``|x - hi - lo| <= 2**-22 *
    |x|`` where both stay normal; or, with ``transpose``, ``(2, C, Rp)``
    holding the parts of ``x.T``.  ``Cp`` (``Rp``) is rounded up to a
    multiple of 4 and the padding is zero.  A non-finite ``x`` gives ``hi =
    x`` and ``lo = 0``."""
    hi = _round_tf32(x)
    lo = torch.where(torch.isfinite(x), _round_tf32(x - hi), 0.0)
    parts = torch.stack((hi, lo))
    if transpose:
        parts = parts.transpose(1, 2)
    out = parts.new_zeros((2, parts.shape[1], _pitch(parts.shape[2])))
    out[:, :, :parts.shape[2]] = parts
    return out


def tf32_split(x, transpose: bool = False):
    """The 3xTF32 pre-pass: the parts of float32 ``x (R, C)`` laid out as
    :func:`tf32_split_ref` lays them out.  On a CUDA tensor it launches
    ``tf32_split_kernel``; on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return tf32_split_ref(x, transpose)
    return KERNEL.split(x, transpose)


class FusedCEKernel:
    """The wrapper of ``csrc/fused_ce.cu``.  ``launches`` counts its calls
    of a partial-kernel launcher (each runs a partial kernel and the
    combine), ``launches_by_variant`` the same calls by :func:`variant`, and
    ``split_launches`` the launches of the 3xTF32 pre-pass (two per
    ``"tf32x3"`` call: ``h`` and ``w``)."""

    def __init__(self):
        self._lib = None
        self.zero_counts()

    def zero_counts(self):
        self.launches = 0
        self.launches_by_variant = dict.fromkeys(TILES, 0)
        self.split_launches = 0

    def _load(self):
        if self._lib is None:
            from .build import csrc_source, load

            self._lib = load(csrc_source("fused_ce.cu"), _SYMBOLS)
        return self._lib

    def _raise(self, rc: int, what: str):
        if rc != 0:
            msg = self._lib.fused_ce_error(rc).decode()
            raise RuntimeError(f"fused_ce {what} launch failed: error {rc} "
                               f"({msg})")

    def split(self, x, transpose: bool = False):
        """Launch the 3xTF32 pre-pass on CUDA float32 ``x (R, C)``; returns
        the parts as :func:`tf32_split_ref` lays them out."""
        if x.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, not {x.device}")
        if x.dtype != torch.float32 or x.dim() != 2 or min(x.shape) < 1:
            raise ValueError(f"want a non-empty float32 (R, C) matrix; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("x is not contiguous")
        R, C = x.shape
        shape = (2, C, _pitch(R)) if transpose else (2, R, _pitch(C))
        lib = self._load()
        with torch.cuda.device(x.device):
            parts = torch.empty(shape, dtype=torch.float32, device=x.device)
            rc = lib.fused_ce_split_launch(
                x.data_ptr(), R, C, int(transpose), parts[0].data_ptr(),
                parts[1].data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        self._raise(rc, "tf32 split")
        self.split_launches += 1
        return parts

    def __call__(self, h, w, labels, v_blk=None):
        _check(h, w, labels)
        dev = h.device
        if dev.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, not {dev}")
        for name, t in (("h", h), ("w", w), ("labels", labels)):
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
        (T, D), V = h.shape, w.shape[1]
        kind = variant(h, w)
        width = split_width(T, V, v_blk, variant=kind)
        n_split = ceil(V / width)
        if n_split > _MAX_SPLITS:
            raise ValueError(f"{n_split} vocab splits exceed {_MAX_SPLITS}; "
                             f"raise v_blk")
        lib = self._load()
        with torch.cuda.device(dev):
            part = torch.empty((3, n_split, T), dtype=torch.float32,
                               device=dev)
            loss = torch.empty(T, dtype=torch.float32, device=dev)
            rest = (labels.data_ptr(), T, D, V, width, n_split,
                    part.data_ptr(), loss.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
            if kind == "tf32x3":
                hp, wp = self.split(h), self.split(w, transpose=True)
                rc = lib.fused_ce_tf32x3_launch(
                    hp[0].data_ptr(), hp[1].data_ptr(), wp[0].data_ptr(),
                    wp[1].data_ptr(), hp.shape[2], *rest)
            elif kind == "wgmma":
                rc = lib.fused_ce_wgmma_launch(h.data_ptr(), w.data_ptr(),
                                               *rest)
            else:
                rc = lib.fused_ce_launch(h.data_ptr(), w.data_ptr(), *rest)
        self._raise(rc, f"{kind} kernel")
        self.launches += 1
        self.launches_by_variant[kind] += 1
        return loss


KERNEL = FusedCEKernel()


def fused_ce_forward(h, w, labels, t_blk: int = 128, v_blk=None):
    """h: (T, D); w: (D, V); labels: (T,) int32 -> per-token loss (T,) f32.

    The keyword arguments keep the reference's names.  ``v_blk`` is the
    vocab range of one split (rounded up to a multiple of the tile width of
    the kernel :func:`variant` picks; ``None`` chooses it to fill the
    card); unlike the reference's, it need not divide ``V``: the ragged
    edge is masked.  ``t_blk`` bounds the tokens the plain version takes at
    a time; the kernels' token tiles are fixed (:data:`TILES`).  Neither
    changes the result beyond rounding.  The reference's ``interpret`` has
    no counterpart: the tensors' device decides."""
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
