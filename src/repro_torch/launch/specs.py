"""Shape-only stand-ins for every model input and state (port of
``repro/launch/specs.py``): trees of :class:`TensorStruct` — shape, dtype
and sharding, no device allocation and no weight drawn — for the batch,
the parameters, the optimizer state and the decode caches.

The reference takes its shapes from ``jax.eval_shape`` of its
initializers.  The port builds the model on PyTorch's meta device, where
:func:`~repro_torch.models.common.dense_init` draws nothing, so even
grok-1-314b's spec tree costs no memory.  Trees follow the reference's
structure and leaf paths (unit leaves stacked along their leading axis),
so a spec compares one for one with the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models import ModelConfig, ShapeSpec
from ..models.sharding import (Sharding, batch_shardings, cache_shardings,
                               leaf_shape, params_shardings, replicated)
from ..optim import AdamWConfig
from ..tree import leaves, map_leaves

META = torch.device("meta")


@dataclass(frozen=True)
class TensorStruct:
    """``jax.ShapeDtypeStruct``: a shape, a dtype and a sharding."""

    shape: tuple
    dtype: torch.dtype
    sharding: Optional[Sharding] = None


def _sds(tree, shardings):
    """A tree of tensors (meta) or structs -> :class:`TensorStruct` s with
    their shardings."""
    def struct(leaf, sharding):
        dtype = (leaf[0] if isinstance(leaf, tuple) else leaf).dtype
        return TensorStruct(leaf_shape(leaf), dtype, sharding)

    return map_leaves(struct, tree, shardings)


def meta_params(cfg: ModelConfig, n_units_override: Optional[int] = None):
    """The LM on the meta device: every parameter's shape and dtype, no
    storage, nothing drawn."""
    from ..models.model import LM

    return LM(cfg, None, META, n_units_override)


def opt_shardings(params, p_shard, opt_cfg: AdamWConfig, mesh) -> dict:
    """:func:`~repro_torch.optim.adamw.opt_state_shardings` as
    :class:`Sharding` s: the optimizer state follows its parameter's
    sharding leaf by leaf (factored ``vr`` / ``vc`` drop the reduced
    axis)."""
    from ..optim.adamw import opt_state_shardings

    pairs = [(s.spec, leaf_shape(p))
             for s, p in zip(leaves(p_shard), leaves(params), strict=True)]
    specs = opt_state_shardings(pairs, replicated(mesh), opt_cfg)
    return {"mu": tuple({k: Sharding(mesh, v) for k, v in mu.items()}
                        for mu in specs["mu"]),
            "step": specs["step"]}


def batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Training / prefill batch: token ids (+ labels for train, + stubbed
    modality-frontend embeddings where the arch requires them)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.input_embed_dim:
        batch["embeds"] = TensorStruct((B, S, cfg.input_embed_dim),
                                       torch.bfloat16)
    else:
        batch["tokens"] = TensorStruct((B, S), torch.int32)
    if cfg.kind == "vlm":
        batch["vision"] = TensorStruct(
            (B, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16)
    if shape.mode == "train":
        batch["labels"] = TensorStruct((B, S), torch.int32)
    return batch


def param_structs(cfg: ModelConfig, mesh,
                  n_units_override: Optional[int] = None,
                  opt_cfg: Optional[AdamWConfig] = None):
    """(parameter structs, optimizer-state structs or None), with their
    shardings on ``mesh``."""
    from ..optim import adamw_init

    params = meta_params(cfg, n_units_override).param_tree()
    p_shard = params_shardings(params, mesh, cfg)
    p_sds = _sds(params, p_shard)
    o_sds = None
    if opt_cfg is not None:
        o_sds = _sds(adamw_init(params, opt_cfg),
                     opt_shardings(params, p_shard, opt_cfg, mesh))
    return p_sds, o_sds


def cache_structs(cfg: ModelConfig, mesh, shape: ShapeSpec,
                  n_units_override: Optional[int] = None,
                  kv_quant: bool = False):
    """The decode state in the reference's structure (``units`` a tuple
    over the unit kinds, each leaf stacked over the units), with its
    shardings."""
    from ..models.model import (init_block_cache, n_units, prelude_kinds,
                                trailing_kinds, unit_kinds)

    nu = n_units(cfg) if n_units_override is None else n_units_override

    def block(kind):
        return init_block_cache(cfg, kind, shape.global_batch,
                                shape.seq_len, kv_quant, META)

    def stacked(kind):
        return map_leaves(lambda t: torch.empty(
            (nu,) + tuple(t.shape), dtype=t.dtype, device=META), block(kind))

    tree = {"units": tuple(stacked(k) for k in unit_kinds(cfg))
            if nu > 0 else None,
            "prelude": tuple(block(k) for k in prelude_kinds(cfg)),
            "trailing": tuple(block(k) for k in trailing_kinds(cfg))}
    return _sds(tree, cache_shardings(tree, mesh, cfg))


def batch_structs_sharded(cfg: ModelConfig, mesh, shape: ShapeSpec) -> dict:
    b = batch_struct(cfg, shape)
    return _sds(b, batch_shardings(b, mesh, cfg))


def decode_token_struct(cfg: ModelConfig, mesh,
                        shape: ShapeSpec) -> TensorStruct:
    b = {"token": TensorStruct((shape.global_batch, 1), torch.int32)}
    return _sds(b, batch_shardings(b, mesh, cfg))["token"]
