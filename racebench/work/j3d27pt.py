"""Frozen counts of the bytes and operations of j3d27pt, from its source
program (not from RACE's plan, so a change of the plan cannot move the
yardstick).

Bytes: each input array read once, each output written once, over the
arrays' and the outputs' own extents; the five scalars (20 bytes at
float32) are left out.  Operations: the source program's Base count a
point, 26 add, 27 mul, 1 div.
"""
ARRAYS = 1  # u
OUTPUTS = 1  # j27
HALO = 1
OPS_PER_POINT = 54
#: a backward (u's and the five scalars' gradients) a point: u's adjoint
#: is the 27 taps of the cotangent transposed (26 add, 27 mul, 1 div); the
#: scalars need the four class sums of u (23 add), each times the
#: cotangent and summed (4 mul, 4 add), and jnorm's term (1 mul, 1 add)
BACKWARD_OPS_PER_POINT = 87


def points(n: int, batch: int = 1) -> int:
    """Points of the iteration space a call computes."""
    return batch * (n - 2 * HALO) ** 3


def forward(n: int, itemsize: int, batch: int = 1) -> tuple:
    """``(bytes, operations)`` of one forward call."""
    nbytes = batch * (ARRAYS * n ** 3 + OUTPUTS * (n - 2 * HALO) ** 3)
    return nbytes * itemsize, OPS_PER_POINT * points(n, batch)


def backward(n: int, itemsize: int, batch: int = 1) -> tuple:
    """``(bytes, operations)`` of one backward: it reads u and the
    cotangent and writes u's gradient."""
    nbytes = batch * (2 * ARRAYS * n ** 3 + OUTPUTS * (n - 2 * HALO) ** 3)
    return nbytes * itemsize, BACKWARD_OPS_PER_POINT * points(n, batch)
