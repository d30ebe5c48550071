"""Sharded giant-grid execution over a mesh of torch devices.

Port of ``repro/shard``.  Spatially partitions a plan's iteration box over
a :class:`~repro_torch.launch.mesh.Mesh` and runs the existing
plan-keyed compiled executor on every shard, with neighbour halos sized
exactly by the per-array offset envelopes.  Single-controller, as the
reference's ``shard_map`` is: one process, one global env in, global
outputs out.  Three layers:

* :mod:`repro_torch.shard.partition` — which grid levels can shard, and
  where each mesh axis lands; refusal is a structured
  :class:`ShardRefusal`, never silent (codes in
  :data:`SHARD_REFUSAL_CODES`).
* :mod:`repro_torch.shard.halo` — per-call halo transport (neighbour-copy
  exchange vs. whole-array recompute, ``"auto"``-picked by a roofline
  heuristic on the H100's constants).
* :mod:`repro_torch.shard.executor` — :func:`compile_sharded` /
  :class:`ShardedRace`: cache-keyed sharded dispatch with an autograd
  backward that re-partitions each adjoint-stencil plan under the same
  mesh.

Importing this package touches no device.
"""
from .executor import ShardedRace, ShardingUnavailable, compile_sharded
from .halo import HALO_STRATEGIES, ArraySpec, HaloProgram, SlabDim, plan_halo
from .partition import (S_DIVISIBILITY, S_ENVELOPE, S_GATHER, S_GEOMETRY,
                        S_HALO, S_MIRRORED, S_NO_AXIS, S_STRIDED,
                        SHARD_REFUSAL_CODES, AxisAssignment, LevelVerdict,
                        PartitionPlan, ShardRefusal, plan_partition)

__all__ = [
    "SHARD_REFUSAL_CODES",
    "S_DIVISIBILITY", "S_ENVELOPE", "S_GATHER", "S_GEOMETRY", "S_HALO",
    "S_MIRRORED", "S_NO_AXIS", "S_STRIDED",
    "ShardRefusal", "LevelVerdict", "AxisAssignment", "PartitionPlan",
    "plan_partition",
    "HALO_STRATEGIES", "SlabDim", "ArraySpec", "HaloProgram", "plan_halo",
    "ShardingUnavailable", "ShardedRace", "compile_sharded",
]
