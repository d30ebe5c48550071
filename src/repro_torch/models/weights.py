"""Carry the reference's parameters into the port's :class:`~.model.LM`.

The reference's param tree (``repro.models.init_params``) as numpy arrays —
``jax.tree.map(np.asarray, params)`` — maps leaf for leaf onto the module's
state: dict keys become attribute names, the stacked ``units`` leaves
(leading axis: the unit) are split over ``LM.units`` (block
``u * len(unit_kinds) + j`` takes unit ``u``'s ``j``-th block), and
``prelude`` / ``trailing`` tuples index their lists.  Dtypes are kept;
bfloat16 arrays (``ml_dtypes``) travel by their 16-bit pattern, so nothing
here imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import leaves_with_paths
from .config import ModelConfig
from .model import LM, init_params, unit_kinds


def to_tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_reference(cfg: ModelConfig, tree: dict, *, device=None,
                   trainable: bool = False) -> LM:
    """An :class:`LM` on ``device`` (default ``cuda``; raises without a GPU)
    holding the reference's parameters ``tree``, trainable or frozen as
    :func:`init_params`.  Raises ``ValueError`` on a leaf the module lacks,
    a parameter the tree lacks, or a shape or dtype that differs."""
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, generator=gen, device=device,
                        n_units_override=_n_units(tree), trainable=trainable)
    state = dict(model.named_parameters())
    nk = len(unit_kinds(cfg))
    filled = set()
    for path, leaf in leaves_with_paths(tree):
        t = to_tensor(leaf)
        if path[0] == "units":
            j, rest = path[1], path[2:]
            parts = [(f"units.{u * nk + j}." + ".".join(map(str, rest)), t[u])
                     for u in range(t.shape[0])]
        else:
            parts = [(".".join(map(str, path)), t)]
        for name, value in parts:
            if name not in state:
                raise ValueError(f"reference leaf {name} has no parameter "
                                 f"in the port's LM")
            p = state[name]
            if tuple(p.shape) != tuple(value.shape) or p.dtype != value.dtype:
                raise ValueError(
                    f"{name}: reference {tuple(value.shape)} {value.dtype}, "
                    f"port {tuple(p.shape)} {p.dtype}")
            with torch.no_grad():
                p.copy_(value)
            filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise ValueError(f"the reference tree lacks {missing}")
    return model


def _n_units(tree: dict) -> int:
    """The unit count of a reference tree (its stacked leaves' leading
    axis)."""
    units = tree.get("units")
    for _, leaf in leaves_with_paths(units):
        return int(np.shape(leaf)[0])
    return 0
