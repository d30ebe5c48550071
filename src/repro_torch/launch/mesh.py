"""Meshes of torch devices (port of ``repro/launch/mesh.py``): the stencil
mesh of the sharded executor and the LM's meshes.

The port is single-controller, as the reference's sharded executor is: one
process holds the global data, places each shard on its device and runs
every shard there.  So a mesh here is no process group but a small object,
:class:`Mesh`: ``axis_names``, a ``shape`` mapping and ``devices``, an
ndarray of ``torch.device`` in that shape — the duck type
:func:`repro_torch.shard.plan_partition` and
:mod:`repro_torch.models.sharding` read.  A device may repeat:
``["cuda:0"] * 4`` is four shards on one card, the counterpart of the
reference's ``--xla_force_host_platform_device_count=4``, and
``["cpu"] * 4`` is what the CPU tests use.  A mesh no process here could
hold (the production meshes' 256 or 512 devices) is *abstract*: axis names
and sizes, no devices; it serves spec trees only.

Importing this module touches no device.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional

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


#: H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, without
#: sparsity, at the 700 W limit), flop/s.  A data-sheet figure, not a
#: measurement.
PEAK_BF16_FLOPS = 989e12
#: H100 SXM device memory (NVIDIA's data sheet), bytes
HBM_BYTES = 80e9


class AbstractMeshError(ValueError):
    """An abstract mesh (axis sizes, no devices) was given to run on."""


@dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of torch devices: ``devices[coords]`` holds the shard at
    those mesh coordinates (one index per axis, in ``axis_names`` order).
    An abstract mesh has ``devices`` None and its axis sizes in ``sizes``."""

    axis_names: tuple
    devices: Optional[np.ndarray]  # object ndarray of torch.device
    sizes: tuple = ()

    def __post_init__(self):
        if self.devices is not None:
            object.__setattr__(self, "sizes", tuple(self.devices.shape))
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not match its "
                             f"shape {self.sizes}")

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return prod(self.sizes)

    def key(self) -> tuple:
        """Cache-key component: ``(((axis, size), ...), (device, ...))``."""
        return (tuple(self.shape.items()), None if self.abstract else
                tuple(str(d) for d in self.devices.flat))

    def __repr__(self) -> str:
        where = ("abstract" if self.abstract else
                 [str(d) for d in self.devices.flat])
        return f"Mesh({self.shape}, {where})"


def _devices(devices) -> list:
    """torch devices of ``devices`` (names or devices), a bare ``"cuda"``
    keyed by the current card's index."""
    import torch

    out = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (e.g. (2, 2) over ``("data",
    "model")``).  ``devices`` lists one device per mesh position, in row-
    major order, and may repeat one (``["cuda:0"] * 4``); ``None`` takes the
    first ``prod(shape)`` visible CUDA devices where there are that many,
    else the mesh is abstract (the production meshes on any one host)."""
    import torch

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    n = prod(shape)
    if devices is None:
        if torch.cuda.device_count() < n:
            return Mesh(axes, None, shape)
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = _devices(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(axes, grid.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16x16 (``data``, ``model``) per
    pod; two pods add a leading ``pod`` axis (2x16x16).  Abstract unless
    this process sees that many CUDA devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_stencil_mesh(n_devices=None, axes=("sx", "sy"),
                      devices=None) -> Mesh:
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
        visible = _devices(devices)
    n = len(visible) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(visible):
        what = "given" if devices is not None else "visible CUDA"
        raise ValueError(
            f"n_devices={n} out of range for {len(visible)} {what} "
            f"device(s)")
    axes = tuple(axes)
    grid = np.empty(n, dtype=object)
    grid[:] = visible[:n]
    return Mesh(axes, grid.reshape(stencil_mesh_shape(n, len(axes))))
