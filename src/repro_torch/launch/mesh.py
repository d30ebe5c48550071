"""Stencil meshes of torch devices (port of ``repro/launch/mesh.py``'s
stencil-mesh functions).

The sharded executor (:mod:`repro_torch.shard`) is single-controller, as
the reference's is: one process holds the global env, runs every shard's
local executor on that shard's device and returns global outputs.  So a
mesh here is no process group but a small object, :class:`StencilMesh`:
``axis_names``, a ``shape`` mapping and ``devices``, an ndarray of
``torch.device`` in that shape — the duck type
:func:`repro_torch.shard.plan_partition` reads.  A device may repeat:
``["cuda:0"] * 4`` is four shards on one card, the counterpart of the
reference's ``--xla_force_host_platform_device_count=4``, and
``["cpu"] * 4`` is what the CPU tests use.

Importing this module touches no device.  The LM stack's
``make_production_mesh`` / ``make_mesh`` are not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: H100 SXM device-memory rate (NVIDIA's data sheet), bytes/s
HBM_BW = 3.35e12
#: NVLink 4 rate of one H100 SXM to its peers, one direction (NVIDIA's data
#: sheet figure for the NVIDIA H100 80GB HBM3: 900 GB/s both ways), bytes/s.
#: A data-sheet figure, not a measurement.  The halo ``"auto"`` pick
#: (:mod:`repro_torch.shard.halo`) weighs exchange bytes over this rate
#: against recompute's replicated reads over :data:`HBM_BW`.
LINK_BW = 450e9
#: H100 SXM peak rates outside the tensor cores (NVIDIA's data sheet),
#: flop/s per element size in bytes: float32 and float64
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def stencil_mesh_shape(n: int, k: int) -> tuple:
    """Factor ``n`` devices into ``k`` near-square mesh dims, largest first.

    Every dim is an exact divisor of ``n`` by construction, so a product
    over any axis subset always divides the device count.  Per trailing
    axis we take the largest divisor no bigger than the remaining count's
    k-th root: 8 -> (4, 2), 4 -> (2, 2), 6 -> (3, 2), primes degrade to
    (n, 1, ...).
    """
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    if k < 1:
        raise ValueError(f"need at least one mesh axis, got {k}")
    dims = []
    for remaining in range(k, 1, -1):
        root = n ** (1.0 / remaining)
        d = max(f for f in range(1, int(root + 1e-9) + 1) if n % f == 0)
        dims.append(d)
        n //= d
    dims.append(n)
    return tuple(sorted(dims, reverse=True))


@dataclass(frozen=True, eq=False)
class StencilMesh:
    """A named grid of torch devices: ``devices[coords]`` runs the shard at
    those mesh coordinates (one index per axis, in ``axis_names`` order)."""

    axis_names: tuple
    devices: np.ndarray  # object ndarray of torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def key(self) -> tuple:
        """Cache-key component: ``(((axis, size), ...), (device, ...))``."""
        return (tuple(self.shape.items()),
                tuple(str(d) for d in self.devices.flat))

    def __repr__(self) -> str:
        return (f"StencilMesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_stencil_mesh(n_devices=None, axes=("sx", "sy"),
                      devices=None) -> StencilMesh:
    """Near-square spatial mesh over ``n_devices`` torch devices.

    ``devices=None`` takes the first ``n_devices`` visible CUDA devices
    (all of them when ``n_devices`` is None) and raises when more are asked
    for than ``torch.cuda.device_count()`` gives — with no card, always.
    An explicit ``devices`` list (names or ``torch.device`` s) may repeat a
    device; ``n_devices`` then defaults to its length and takes its first
    ``n_devices`` entries."""
    import torch

    if devices is None:
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(d) for d in devices]
        # "cuda" names the current card: key the mesh by its index
        visible = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in visible]
    n = len(visible) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(visible):
        what = "given" if devices is not None else "visible CUDA"
        raise ValueError(
            f"n_devices={n} out of range for {len(visible)} {what} "
            f"device(s)")
    axes = tuple(axes)
    grid = np.empty(n, dtype=object)
    grid[:] = visible[:n]
    return StencilMesh(axes, grid.reshape(stencil_mesh_shape(n, len(axes))))
