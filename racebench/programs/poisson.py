"""The benchmark's frozen copy of the 19-point Poisson relaxation (RACE
paper, Table 1, poisson), written in the port's IR.

It does not read the port's case registry, so a later edit of the registry
cannot change what the benchmark measures.  Arrays are indexed
``u[i, k, j]`` as in the paper's Fortran; the loops run over the interior,
one point in from every face.
"""
from repro_torch.core.ir import Scalar, arr, loopnest, program

ARRAYS = ("u",)
SCALARS = ("pc0", "pc1", "pc2")
OUTPUTS = ("pois",)
#: points between an array's face and the loop nest's first point
HALO = 1


def array_shape(n: int) -> tuple:
    """The shape of each input array at extent ``n``: an ``n``-cube."""
    return (n, n, n)


def output_shape(n: int) -> tuple:
    """The shape of each output: the interior of an ``n``-cube."""
    return (n - 2 * HALO,) * 3


def build(n: int):
    """``pois = pc0 * u - pc1 * (u's 6 face neighbours) - pc2 * (its 12
    edge neighbours)`` over an ``n``-cube's interior, each class summed in
    the order of its offsets (di, then dk, then dj): 19 values of one
    array, Table 1's Base of 16 add, 2 sub and 3 mul."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2),
                                ("i", 1, n - 2))
    u, out = arr("u"), arr("pois")
    c = [Scalar(f"pc{m}") for m in range(3)]

    def ring(cls):
        acc = None
        for di in (-1, 0, 1):
            for dk in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if (di != 0) + (dk != 0) + (dj != 0) == cls:
                        tap = u[i + di, k + dk, j + dj]
                        acc = tap if acc is None else acc + tap
        return acc

    body = (c[0] * u[i, k, j] - c[1] * ring(1)) - c[2] * ring(2)
    return program(loops, [(out[i, k, j], body)])
