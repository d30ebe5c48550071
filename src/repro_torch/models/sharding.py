"""Sharding rules of the port (``repro/models/sharding.py``): parameter-name
based partition specs with divisibility guards, and the placement of a
tensor's shards on a mesh of torch devices.

Layout (the reference's): ``data`` (plus ``pod`` when present) is the FSDP
axis — parameters, gradients and optimizer state are sharded over it;
``model`` carries tensor parallelism (attention projections, FFN and expert
FFN slices, vocab) and the sequence dimension of decode KV caches.

Every rule passes through ``_fit``: a dimension only gets mesh axes whose
total size divides it (e.g. granite's vocab 49155 stays replicated on that
dimension while its d_model shards).

The port is single-controller (:mod:`repro_torch.launch.mesh`): a
:class:`Sharding` is a mesh and a :class:`PartitionSpec`, :func:`place`
cuts a tensor into the shards each mesh position holds and copies each to
its device, and :func:`gather` puts them back together, bit for bit.  Spec
trees are keyed by the reference's paths (:mod:`repro_torch.tree`), so the
specs of leaf ``units/0/attn/wq`` compare one for one with the
reference's.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from math import prod
from typing import Optional

import numpy as np
import torch

from ..tree import Stack, map_leaves, map_with_paths
from .config import ModelConfig


class PartitionSpec(tuple):
    """Per tensor dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of axis names (major first), as ``jax.sharding.PartitionSpec``,
    which it also canonicalizes as: a one-name tuple is that name, an empty
    one ``None``."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                return None if not p else p[0] if len(p) == 1 else tuple(p)
            return p

        return super().__new__(cls, tuple(canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class Sharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec


def leaf_shape(leaf) -> tuple:
    """A leaf's shape: a :class:`~repro_torch.tree.Stack` 's stacked one."""
    if isinstance(leaf, Stack):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axes(mesh) -> tuple:
    # FSDP shards params over the data axes; 'model' already shards via TP
    return batch_axes(mesh)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def divides(mesh, dim: int, axes) -> bool:
    """True when ``dim`` is positive and the total size of ``axes`` over
    ``mesh`` divides it evenly (the ``_fit`` guard)."""
    return dim > 0 and dim % _axsize(mesh, axes) == 0


def _fit(mesh, shape, spec) -> PartitionSpec:
    """Drop axes from dims they don't divide."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is not None and divides(mesh, dim, axes):
            out.append(axes)
        else:
            out.append(None)
    return P(*out)


# suffix-match rules: (names, spec builder); 'F' = fsdp, 'T' = model/tensor
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "x_proj",
        "w_input_gate", "w_rec_gate", "head", "embed"}
_ROW = {"wo", "w_down", "out_proj", "dt_proj"}


def param_spec(path: tuple, shape: tuple, mesh, cfg: ModelConfig) -> P:
    name = str(path[-1])
    F, T = fsdp_axes(mesh), "model"
    ndim = len(shape)
    lead = ndim - 2  # scan-stacked L and/or expert E leading axes

    def with_lead(*tail):
        return P(*([None] * lead), *tail)

    if name == "embed":
        return _fit(mesh, shape, P(T, F))
    if name == "head":
        return _fit(mesh, shape, P(F, T))
    if name == "router":
        return _fit(mesh, shape, with_lead(F, None))
    if name in _COL and ndim >= 2:
        return _fit(mesh, shape, with_lead(F, T))
    if name in _ROW and ndim >= 2:
        return _fit(mesh, shape, with_lead(T, F))
    if name == "conv_w":
        return _fit(mesh, shape, P(*([None] * (ndim - 1)), T))
    if name in ("A_log", "D_skip", "dt_bias", "lambda_p"):
        return _fit(mesh, shape, P(*([None] * (ndim - 2) if ndim >= 2 else []),
                                   T, *([None] if ndim >= 2 else [])))
    # norms, biases, scalars: replicated
    return P(*([None] * ndim))


def params_shardings(params, mesh, cfg: ModelConfig):
    """A :class:`Sharding` per leaf of ``params`` (an LM's ``param_tree()``,
    or a tree of tensors or shape structs), by the reference's path."""
    tree = params.param_tree() if hasattr(params, "param_tree") else params
    return map_with_paths(lambda path, leaf: Sharding(
        mesh, param_spec(path, leaf_shape(leaf), mesh, cfg)), tree)


def batch_shardings(batch_tree, mesh, cfg: ModelConfig):
    """tokens/labels (B, S); embeds (B, S, E); vision (B, T, Dv)."""
    B_ax = batch_axes(mesh)

    def spec(leaf):
        shape = leaf_shape(leaf)
        sp = [B_ax] + [None] * (len(shape) - 1)
        return Sharding(mesh, _fit(mesh, shape, P(*sp)))

    return map_leaves(spec, batch_tree)


def cache_shardings(cache_tree, mesh, cfg: ModelConfig):
    """Decode-state shardings, keyed by leaf name (leaves may carry a stacked
    leading L axis):
      k/v   ([L], B, S, KV, dh): batch on data axes, cache *sequence* on
            'model' — flash-decoding-style split-K;
      conv  ([L], B, K-1, C):    channels on 'model';
      h     ([L], B, di, N) or ([L], B, W): state width on 'model'."""
    B_ax = batch_axes(mesh)

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        shape = leaf_shape(leaf)
        nd = len(shape)
        if name in ("k", "v"):
            sp = [None] * (nd - 4) + [B_ax, "model", None, None]
        elif name in ("k_scale", "v_scale"):
            sp = [None] * (nd - 3) + [B_ax, "model", None]
        elif name == "conv":
            sp = [None] * (nd - 3) + [B_ax, None, "model"]
        elif name == "h":
            if shape[-1] <= 64 and nd >= 3:  # mamba (B, di, N)
                sp = [None] * (nd - 3) + [B_ax, "model", None]
            else:  # rg-lru (B, W)
                sp = [None] * (nd - 2) + [B_ax, "model"]
        else:
            sp = [None] * nd
        return Sharding(mesh, _fit(mesh, shape, P(*sp)))

    return map_with_paths(spec, cache_tree)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, P())


def activation_spec(mesh) -> Sharding:
    return Sharding(mesh, P(batch_axes(mesh), None, None))


# ---------------------------------------------------------------------------
# placement: a tensor's shards on the mesh's devices
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Placed:
    """A tensor as its shards: ``shards[coords]`` is the block the mesh
    position ``coords`` holds, on that position's device (a replicated
    block is copied to every position that holds it)."""

    shape: tuple
    dtype: torch.dtype
    sharding: Sharding
    shards: np.ndarray  # object ndarray in the mesh's shape


def _blocks(shape: tuple, sharding: Sharding):
    """``(coords, slices)`` per mesh position: the block of a tensor of
    ``shape`` that position holds.  A dimension split over axes ``(a, b)``
    has ``size(a) * size(b)`` equal blocks, ``a`` major."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    spec = spec + (None,) * (len(shape) - len(spec))
    sizes = mesh.shape
    for coords in itertools.product(*(range(n) for n in mesh.sizes)):
        at = dict(zip(mesh.axis_names, coords))
        slices = []
        for dim, axes in zip(shape, spec):
            axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
            n = prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {dim} does not split over "
                                 f"{axes} ({n} blocks)")
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + at[a]
            step = dim // n
            slices.append(slice(idx * step, (idx + 1) * step))
        yield coords, tuple(slices)


def place(t: torch.Tensor, sharding: Sharding) -> Placed:
    """``t`` cut into the shards of ``sharding``, each a contiguous copy on
    its mesh position's device."""
    mesh = sharding.mesh
    if mesh.abstract:
        raise ValueError(f"{mesh} is abstract: it holds no devices")
    shards = np.empty(mesh.sizes, dtype=object)
    for coords, sl in _blocks(tuple(t.shape), sharding):
        block = t[sl]
        shards[coords] = torch.empty(block.shape, dtype=t.dtype,
                                     device=mesh.devices[coords]).copy_(block)
    return Placed(tuple(t.shape), t.dtype, sharding, shards)


def gather(placed: Placed, device=None) -> torch.Tensor:
    """The tensor :func:`place` cut into ``placed``, assembled on ``device``
    (default: the first shard's), bit for bit."""
    first = placed.shards.flat[0]
    out = torch.empty(placed.shape, dtype=placed.dtype,
                      device=first.device if device is None else device)
    for coords, sl in _blocks(placed.shape, placed.sharding):
        out[sl].copy_(placed.shards[coords])
    return out


def gather_tree(tree, device: Optional[torch.device] = None):
    """:func:`gather` on every :class:`Placed` leaf of ``tree``."""
    return map_leaves(lambda p: gather(p, device), tree)
