"""int8 error-feedback gradient compression (``repro/optim/compression.py``).

For explicit data-parallel gradient synchronization, gradients are quantized
to int8 with a per-tensor scale before the all-reduce and the quantization
error is carried to the next step (error feedback keeps SGD/Adam
convergence; Seide et al. 2014, Karimireddy et al. 2019).  A unit leaf
(:class:`~repro_torch.tree.Stack`) takes one scale over its stacked array,
as the reference's ``(L, ...)`` leaf does.
"""
from __future__ import annotations

import torch

from ..tree import as_array, leaves, like, map_leaves, unflatten


def ef_int8_compress(g, err):
    """g, err: float32 tensors.  Returns (q int8, scale float32 scalar,
    new_err); ``torch.round`` rounds half to even, as ``jnp.round``."""
    x = g + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    return q, scale, new_err


def ef_int8_decompress(q, scale):
    return q.float() * scale


def compress_tree(grads, err_tree):
    gs = leaves(grads)
    es = (leaves(err_tree) if err_tree is not None else
          [torch.zeros_like(as_array(g), dtype=torch.float32) for g in gs])
    out = [ef_int8_compress(as_array(g).float(), as_array(e))
           for g, e in zip(gs, es, strict=True)]
    return (unflatten(grads, [like(g, t[0]) for g, t in zip(gs, out)]),
            unflatten(grads, [t[1] for t in out]),
            unflatten(grads, [like(g, t[2]) for g, t in zip(gs, out)]))


def decompress_tree(q, s):
    return map_leaves(lambda qq, ss: like(qq, ef_int8_decompress(
        as_array(qq), ss)), q, s)
