"""Explicit data-parallel gradient synchronization with int8 error-feedback
compression (``repro/runtime/grad_sync.py``).

Each member of a data-parallel axis quantizes its local gradient (plus the
error it carried) to int8 with one float32 scale; the int8 payloads and
the scales are gathered to every member (4x fewer bytes than a float32
all-reduce), each member forms the de-quantized mean, and the quantization
error is carried into the next round (Karimireddy et al. 2019).

The port is single-controller (:mod:`repro_torch.launch.mesh`): where the
reference runs inside ``shard_map`` over a named axis, here "the axis" is
the list of its members' local gradients, each on its member's device, and
the gather is a copy of every payload to every member's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..optim.compression import ef_int8_compress
from ..tree import leaves, unflatten


def compressed_pmean(gs: Sequence[torch.Tensor],
                     errs: Optional[Sequence[torch.Tensor]] = None):
    """One leaf over one axis: the members' local gradients ``gs`` and
    carried errors ``errs`` (float32; None: zeros) -> (the mean on each
    member's device, in the gradient's dtype; each member's new error).
    Every member computes its mean from the same gathered payload, so the
    members agree bit for bit."""
    n = len(gs)
    if errs is None:
        errs = [torch.zeros_like(g, dtype=torch.float32) for g in gs]
    local = [ef_int8_compress(g.float(), e) for g, e in zip(gs, errs,
                                                            strict=True)]
    means = []
    for g in gs:
        qs = torch.stack([q.to(g.device) for q, _, _ in local])  # the wire
        ss = torch.stack([s.to(g.device) for _, s, _ in local])
        mean = torch.tensordot(ss, qs.float(), dims=([0], [0])) / n
        means.append(mean.to(g.dtype))
    return means, [e for _, _, e in local]


def compressed_pmean_tree(grads: Sequence, errs: Optional[Sequence] = None):
    """:func:`compressed_pmean` over every leaf of the members' gradient
    trees ``grads`` (one tree per member, the same structure) and their
    error trees: (a mean tree per member, an error tree per member)."""
    flat = [leaves(g) for g in grads]
    flat_e = ([leaves(e) for e in errs] if errs is not None
              else [None] * len(grads))
    means = [[] for _ in grads]
    new_errs = [[] for _ in grads]
    for i in range(len(flat[0])):
        es = None if errs is None else [fe[i] for fe in flat_e]
        m, e = compressed_pmean([f[i] for f in flat], es)
        for k in range(len(grads)):
            means[k].append(m[k])
            new_errs[k].append(e[k])
    return ([unflatten(g, m) for g, m in zip(grads, means)],
            [unflatten(g, e) for g, e in zip(grads, new_errs)])


def wire_bytes(grads: Sequence) -> tuple:
    """(int8 bytes, float32 bytes) one member's payload puts on the wire:
    its int8 gradient plus one float32 scale per leaf, against the float32
    gradient a plain mean would move."""
    ls = leaves(grads[0])
    n = sum(g.numel() for g in ls)
    return n + 4 * len(ls), 4 * n
