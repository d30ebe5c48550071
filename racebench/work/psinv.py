"""Frozen counts of the bytes and operations of psinv, from its source
program (not from RACE's plan, so a change of the plan cannot move the
yardstick).

Bytes: each input array read once, each output written once, over the
arrays' and the outputs' own extents; the four scalars are left out.
Operations: the source program's Base count a point, 27 add and 4 mul
(the paper's Table 1).
"""
ARRAYS = 2  # u, r
OUTPUTS = 1  # u
HALO = 1
OPS_PER_POINT = 31


def points(n: int, batch: int = 1) -> int:
    """Points of the iteration space a call computes."""
    return batch * (n - 2 * HALO) ** 3


def forward(n: int, itemsize: int, batch: int = 1) -> tuple:
    """``(bytes, operations)`` of one forward call."""
    nbytes = batch * (ARRAYS * n ** 3 + OUTPUTS * (n - 2 * HALO) ** 3)
    return nbytes * itemsize, OPS_PER_POINT * points(n, batch)
