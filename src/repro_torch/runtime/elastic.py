"""Elastic scaling (``repro/runtime/elastic.py``): rebuild the mesh at a new
device count and re-shard the logical checkpoint onto it.

Checkpoints are saved unsharded and logical (:mod:`repro_torch.checkpoint`),
so moving from N to M devices is: build the new mesh -> compute the
sharding trees for it -> ``restore_checkpoint(..., shardings=new)``, which
places each array's shards on their mesh devices.  The port is
single-controller: the result's leaves are
:class:`~repro_torch.models.sharding.Placed` tensors, and
:func:`~repro_torch.models.sharding.gather_tree` puts them back together
bit for bit.
"""
from __future__ import annotations

from ..checkpoint import restore_checkpoint
from ..launch.mesh import make_mesh
from ..launch.specs import opt_shardings
from ..models.sharding import params_shardings
from ..optim import AdamWConfig


def reshard_checkpoint(ckpt_dir, like_tree, cfg, mesh_shape, mesh_axes,
                       step=None, devices=None):
    """Restore a checkpoint re-sharded for a new mesh geometry: ``(state,
    step, mesh)``.  ``like_tree`` gives the structure and shapes
    (``{"params": ..., "opt": ...}``; meta tensors or shape structs do:
    nothing is read from it); ``devices`` the mesh's devices, as
    :func:`~repro_torch.launch.mesh.make_mesh` takes them."""
    mesh = make_mesh(mesh_shape, mesh_axes, devices)
    params = like_tree["params"]
    shard = {"params": params_shardings(params, mesh, cfg)}
    if "opt" in like_tree:
        # the moments follow their parameter's sharding; a factored state
        # (vr / vc) drops the reduced axis
        factored = any("vr" in mu for mu in like_tree["opt"]["mu"])
        shard["opt"] = opt_shardings(params, shard["params"],
                                     AdamWConfig(factored=factored), mesh)
    state, step = restore_checkpoint(ckpt_dir, like_tree, step=step,
                                     shardings=shard)
    return state, step, mesh
