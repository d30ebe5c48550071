"""Frozen counts of the bytes and operations of poisson, from its source
program (not from RACE's plan, so a change of the plan cannot move the
yardstick).

Bytes: the one input array read once, the output written once, over the
array's and the output's own extents; the three scalars are left out.
Operations: the source program's own count a point, Table 1's Base of
16 add, 2 sub and 3 mul.
"""
ARRAYS = 1  # u
OUTPUTS = 1  # pois
HALO = 1
OPS_PER_POINT = 21


def points(n: int, batch: int = 1) -> int:
    """Points of the iteration space a call computes."""
    return batch * (n - 2 * HALO) ** 3


def forward(n: int, itemsize: int, batch: int = 1) -> tuple:
    """``(bytes, operations)`` of one forward call."""
    nbytes = batch * (ARRAYS * n ** 3 + OUTPUTS * (n - 2 * HALO) ** 3)
    return nbytes * itemsize, OPS_PER_POINT * points(n, batch)
