"""Halo transport for sharded plan execution, sized by offset envelopes.

Port of ``repro/shard/halo.py``.  Given a
:class:`~repro_torch.shard.partition.PartitionPlan` and the *local* plan
(the global plan re-ranged to one chunk), this module builds a
:class:`HaloProgram`: how each env entry reaches the shards (its
:class:`ArraySpec`), the per-shard index boxes of every slab and output,
and the prologue that turns the global env into exactly the env each
shard's local executor reads.  Every slab is sized by the per-array
*program* offset envelopes (:func:`repro_torch.lowering.geometry.
analyze_program`, see :mod:`repro_torch.shard.partition`) and nothing else:
the right-halo along a sharded dim is ``t = max(0, lo + off_hi)`` for *that
array*, so a 3-point stencil ships one plane while a 5-point one ships
two, per array, never a worst-case union.

The reference runs one ``shard_map`` over a jax mesh; the port is
single-controller over a mesh of torch devices
(:class:`~repro_torch.launch.mesh.Mesh`): one process holds the
global env and builds one local env per shard, on that shard's device
(:meth:`HaloProgram.local_envs`).  Two transport strategies produce
bit-identical local slabs:

* ``"exchange"`` — each shard receives its core block ``u[p·e : p·e + e]``
  of every sharded dim; per halo dim it takes its right neighbour's
  leading ``t``-slab, copied to its own device (``Tensor.to(dev,
  non_blocking=True)``, the counterpart of ``lax.ppermute``), and
  concatenates.  The last
  shard's halo is the global tail ``u[E:E+t]``.  With ``k`` haloed dims
  the corner problem is solved subset-by-subset, as in the reference: one
  block per subset ``S`` of haloed dims (dims in ``S`` carry the global
  tail, the others the shard's core), extended along each dim in a fixed
  order — after dim ``i`` every block not containing ``i`` has grown to
  ``e_i + t_i``, so edges and corners arrive shape-consistent without
  dedicated corner sends.
* ``"recompute"`` — every shard's device gets the whole array and the
  shard slices its own overlap-extended slab ``[p·e : p·e + e + t]``.  No
  neighbour copies, but every shard reads the full array each call.

Either way the prologue materializes every local slab contiguous (a slice
along a dim other than the outermost is strided, and K1 takes contiguous
operands only): :attr:`HaloProgram.slab_bytes` counts the slabs, which
``"recompute"`` writes once and ``"exchange"``'s concatenations about once
per halo dim.

``"auto"`` picks by a bytes-over-bandwidth roofline using the port's
H100 constants (:mod:`repro_torch.launch.mesh`, not the reference's v5e
ones): exchange moves its halo bytes over NVLink (``LINK_BW``), recompute
reads one full copy per shard through device memory (``HBM_BW``).
Auxiliary-array halo *flops* do not enter the comparison: both strategies
hand the executor the same envelope-extended slab and recompute aux values
over it locally, so that work is identical and cancels.  The byte counts
(:meth:`HaloProgram._exchange_bytes`, :meth:`HaloProgram._restack_bytes`)
are the reference's, unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.codegen import required_shapes
from ..launch.mesh import HBM_BW, LINK_BW
from ..lowering.geometry import K_WINDOW, analyze_program

HALO_STRATEGIES = ("auto", "exchange", "recompute")

#: ArraySpec.mode values
M_SLAB = "slab"  # sliced along >=1 sharded dim, halo-extended
M_REPLICATED = "replicated"  # passed whole to every shard
M_CANVAS = "canvas"  # output-only: synthesized as zeros on each shard
M_SCALAR = "scalar"  # rank-0 passthrough


@dataclass(frozen=True)
class SlabDim:
    """One sharded dim of one array."""

    dim: int  # array dim index
    level: int
    mesh_axis: str
    shards: int
    chunk: int  # e: core elements per shard
    extent: int  # E: global core extent (shards * chunk)
    halo: int  # t: this array's right-halo width along this dim


@dataclass(frozen=True)
class ArraySpec:
    """How one env entry reaches the shards."""

    name: str
    mode: str
    shape: tuple  # global shape from the env signature ((), scalar)
    dtype: str
    slabs: tuple = ()  # SlabDim ascending by dim (slab mode only)
    local_shape: tuple = ()  # what the local executor sees


def _subsets(dims: tuple) -> list:
    out = [frozenset()]
    for d in dims:
        out += [s | {d} for s in out]
    return out


def _nbytes(shape, dtype: str) -> int:
    size = np.dtype(dtype).itemsize
    for n in shape:
        size *= n
    return size


def shards_of(mesh) -> list:
    """``[(coords, device), ...]`` in ``mesh.devices.flat`` order; ``coords``
    maps each mesh axis to the shard's index along it."""
    return [(dict(zip(mesh.axis_names, idx)), mesh.devices[idx])
            for idx in np.ndindex(mesh.devices.shape)]


class HaloProgram:
    """Static halo plan: per-shard boxes and the prologue for one
    partition."""

    def __init__(self, partition, local_plan, env_sig, strategy: str = "auto"):
        if strategy not in HALO_STRATEGIES:
            raise ValueError(
                f"halo strategy {strategy!r} not in {HALO_STRATEGIES}")
        self.partition = partition
        self.local_plan = local_plan
        # program-level geometry: the influencing reach (see partition.py);
        # the local program's envelopes equal the global ones — re-ranging
        # loops changes no reference offsets
        analysis = analyze_program(local_plan.program)
        if not analysis.eligible:
            raise ValueError("partition accepted an ineligible program")
        by_level = partition.by_level
        out_names = [st.lhs.name for st in local_plan.body]
        read = set(analysis.arrays)
        local_req = required_shapes(local_plan.program)

        specs = {}
        for nm, shape, dtype in env_sig:
            if not shape:
                specs[nm] = ArraySpec(nm, M_SCALAR, shape, dtype)
                continue
            info = analysis.arrays.get(nm)
            slabs = []
            if info is not None and info.kind == K_WINDOW:
                for d, level in enumerate(info.dims):
                    a = by_level.get(level)
                    if a is None:
                        continue
                    t = max(0, a.lo + info.off_hi[level])
                    slabs.append(SlabDim(d, level, a.mesh_axis, a.shards,
                                         a.chunk, a.extent, t))
            if slabs:
                local = list(shape)
                for sd in slabs:
                    local[sd.dim] = sd.chunk + sd.halo
                specs[nm] = ArraySpec(nm, M_SLAB, shape, dtype,
                                      tuple(slabs), tuple(local))
            elif nm in read:
                specs[nm] = ArraySpec(nm, M_REPLICATED, shape, dtype,
                                      local_shape=shape)
            elif nm in out_names:
                specs[nm] = ArraySpec(nm, M_CANVAS, shape, dtype,
                                      local_shape=tuple(local_req[nm]))
            else:  # unreferenced extra env entry: hand it through whole
                specs[nm] = ArraySpec(nm, M_REPLICATED, shape, dtype,
                                      local_shape=shape)
        self.specs = specs

        n_devices = 1
        for _, size in partition.mesh_axes:
            n_devices *= size
        slab_specs = [s for s in specs.values() if s.mode == M_SLAB]
        self.halo_bytes = sum(self._exchange_bytes(s, n_devices)
                              for s in slab_specs)
        self.restack_bytes = sum(self._restack_bytes(s, n_devices)
                                 for s in slab_specs)
        #: bytes of the contiguous local slabs the prologue writes per call
        #: (every shard's, under either strategy)
        self.slab_bytes = sum(_nbytes(s.local_shape, s.dtype) * n_devices
                              for s in slab_specs)
        if strategy == "auto":
            strategy = ("exchange"
                        if self.halo_bytes / LINK_BW
                        <= self.restack_bytes / HBM_BW else "recompute")
        self.strategy = strategy

        # outputs: each shard's local interior lands in the global interior
        # at its chunk along every assigned level (replicated elsewhere)
        self.out_axes = {}
        self.out_local_extent = {}
        ranges = local_plan.program.ranges()
        for st in local_plan.body:
            axes = []
            ext = []
            for s in st.lhs.subs:
                a = by_level.get(s.s)
                axes.append(a.mesh_axis if a is not None else None)
                lo, hi = ranges[s.s]
                ext.append(hi - lo + 1)
            self.out_axes[st.lhs.name] = tuple(axes)
            self.out_local_extent[st.lhs.name] = tuple(ext)

    # -- static accounting ----------------------------------------------------

    @staticmethod
    def _halo_dims(spec: ArraySpec) -> tuple:
        return tuple(sd.dim for sd in spec.slabs if sd.halo > 0)

    def _exchange_bytes(self, spec: ArraySpec, n_devices: int) -> int:
        """Neighbour-copy payload per call, summed over every shard
        (mirrors :meth:`_exchange` exactly)."""
        item = np.dtype(spec.dtype).itemsize
        by_dim = {sd.dim: sd for sd in spec.slabs}
        halo_dims = self._halo_dims(spec)
        total = 0
        for i_pos, i in enumerate(halo_dims):
            sd_i = by_dim[i]
            if sd_i.shards <= 1:
                continue
            for s in _subsets(tuple(d for d in halo_dims if d != i)):
                size = item
                for d, n in enumerate(spec.shape):
                    sd = by_dim.get(d)
                    if sd is None:
                        size *= n
                    elif d == i:
                        size *= sd.halo
                    elif d in s:
                        size *= sd.halo
                    elif d in halo_dims[:i_pos]:
                        size *= sd.chunk + sd.halo  # already extended
                    else:
                        size *= sd.chunk
                # one copy along axis i per combination of the other mesh
                # coordinates; (shards - 1) senders each
                total += size * (n_devices // sd_i.shards) * (sd_i.shards - 1)
        return total

    def _restack_bytes(self, spec: ArraySpec, n_devices: int) -> int:
        """Memory traffic per call under recompute: every shard reads the
        full array to carve its slab."""
        return _nbytes(spec.shape, spec.dtype) * n_devices

    # -- per-shard index boxes ------------------------------------------------

    @staticmethod
    def slab_box(spec: ArraySpec, coords) -> tuple:
        """The global index box of one shard's local slab of ``spec``."""
        box = [slice(None)] * len(spec.shape)
        for sd in spec.slabs:
            start = coords[sd.mesh_axis] * sd.chunk
            box[sd.dim] = slice(start, start + sd.chunk + sd.halo)
        return tuple(box)

    def out_shape(self, name: str) -> tuple:
        """Global interior shape of one output."""
        shards = dict(self.partition.mesh_axes)
        return tuple(n * (shards[ax] if ax is not None else 1)
                     for ax, n in zip(self.out_axes[name],
                                      self.out_local_extent[name]))

    def out_box(self, name: str, coords) -> tuple:
        """The global index box of one shard's local interior of ``name``."""
        return tuple(
            slice(None) if ax is None else slice(coords[ax] * n,
                                                 (coords[ax] + 1) * n)
            for ax, n in zip(self.out_axes[name],
                             self.out_local_extent[name]))

    # -- the prologue and the epilogue ----------------------------------------

    def local_envs(self, env, shards) -> list:
        """One local env per shard of :func:`shards_of`, each on its shard's
        device, from the global tensor env."""
        import torch

        envs = [{} for _ in shards]
        for nm, spec in self.specs.items():
            if spec.mode == M_CANVAS:
                dt = getattr(torch, spec.dtype)
                for le, (_, dev) in zip(envs, shards):
                    le[nm] = torch.zeros(spec.local_shape, dtype=dt,
                                         device=dev)
            elif spec.mode in (M_SCALAR, M_REPLICATED):
                for le, (_, dev) in zip(envs, shards):
                    le[nm] = env[nm].to(dev, non_blocking=True)
            elif self.strategy == "recompute":
                for le, (coords, dev) in zip(envs, shards):
                    whole = env[nm].to(dev, non_blocking=True)
                    le[nm] = whole[self.slab_box(spec, coords)].contiguous()
            else:
                for le, slab in zip(envs, self._exchange(env[nm], spec,
                                                         shards)):
                    le[nm] = slab
        return envs

    def _exchange(self, arr, spec: ArraySpec, shards) -> list:
        """Exchange prologue: every shard's contiguous slab of ``arr``."""
        import torch

        by_dim = {sd.dim: sd for sd in spec.slabs}
        halo_dims = self._halo_dims(spec)
        index = {tuple(c.values()): k for k, (c, _) in enumerate(shards)}
        names = list(shards[0][0])  # the mesh's axis names, in order
        cur = []  # per shard: {subset of halo dims: block on its device}
        for coords, dev in shards:
            blocks = {}
            for s in _subsets(halo_dims):
                box = []
                for d in range(len(spec.shape)):
                    sd = by_dim.get(d)
                    if sd is None:
                        box.append(slice(None))
                    elif d in s:
                        box.append(slice(sd.extent, sd.extent + sd.halo))
                    else:
                        start = coords[sd.mesh_axis] * sd.chunk
                        box.append(slice(start, start + sd.chunk))
                blocks[s] = arr[tuple(box)].to(dev, non_blocking=True)
            cur.append(blocks)
        for i in halo_dims:
            sd = by_dim[i]
            ax = names.index(sd.mesh_axis)
            for s in _subsets(tuple(d for d in halo_dims if d != i)):
                leads = [blk[s].narrow(sd.dim, 0, sd.halo) for blk in cur]
                for k, (coords, dev) in enumerate(shards):
                    if coords[sd.mesh_axis] == sd.shards - 1:
                        halo = cur[k][s | {i}]
                    else:
                        right = list(coords.values())
                        right[ax] += 1
                        halo = leads[index[tuple(right)]].to(
                            dev, non_blocking=True)
                    cur[k][s] = torch.cat([cur[k][s], halo], dim=sd.dim)
        return [blk[frozenset()].contiguous() for blk in cur]

    def assemble(self, outs: list, shards, device) -> dict:
        """Global interior outputs on ``device`` from every shard's local
        interior outputs (a mesh axis an output does not carry is
        replicated: its coordinate-0 shards supply the value)."""
        import torch

        result = {}
        for nm, axes in self.out_axes.items():
            used = {ax for ax in axes if ax is not None}
            first = outs[0][nm]
            glob = torch.empty(self.out_shape(nm), dtype=first.dtype,
                               device=device)
            for out, (coords, _) in zip(outs, shards):
                if any(i for ax, i in coords.items() if ax not in used):
                    continue
                glob[self.out_box(nm, coords)].copy_(out[nm],
                                                     non_blocking=True)
            result[nm] = glob
        return result


def plan_halo(partition, local_plan, env_sig,
              strategy: str = "auto") -> HaloProgram:
    """Build the halo program for one (partition, local plan, signature)."""
    return HaloProgram(partition, local_plan, env_sig, strategy)
