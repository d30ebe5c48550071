"""The benchmark's frozen copy of the 27-point 3-D Jacobi (RACE paper,
Table 1, j3d27pt), written in the port's IR.

It does not read the port's case registry, so a later edit of the registry
cannot change what the benchmark measures.  Arrays are indexed
``u[i, k, j]`` as in the paper's Fortran; the loops run over the interior,
one point in from every face.
"""
from repro_torch.core.ir import Scalar, arr, loopnest, program

ARRAYS = ("u",)
SCALARS = ("jc0", "jc1", "jc2", "jc3", "jnorm")
OUTPUTS = ("j27",)
#: points between an array's face and the loop nest's first point
HALO = 1


def array_shape(n: int) -> tuple:
    """The shape of each input array at extent ``n``: an ``n``-cube."""
    return (n, n, n)


def output_shape(n: int) -> tuple:
    """The shape of each output: the interior of an ``n``-cube."""
    return (n - 2 * HALO,) * 3


def build(n: int):
    """The loop nest over an ``n``-cube: ``j27 = sum_taps jc[class] * u /
    jnorm``, one product per tap, the class being the number of nonzero
    offsets (0 centre, 1 faces, 2 edges, 3 corners)."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2),
                                ("i", 1, n - 2))
    u, out = arr("u"), arr("j27")
    weight = [Scalar(f"jc{c}") for c in range(4)]
    acc = None
    for di in (-1, 0, 1):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                term = (weight[(di != 0) + (dk != 0) + (dj != 0)]
                        * u[i + di, k + dk, j + dj])
                acc = term if acc is None else acc + term
    return program(loops, [(out[i, k, j], acc / Scalar("jnorm"))])
