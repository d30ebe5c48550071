"""The benchmark's frozen copy of NAS MG's smoother ``psinv`` as the RACE
paper prints it (Fig. 6; Table 1, mgrid psinv), written in the port's IR.

It does not read the port's case registry, so a later edit of the registry
cannot change what the benchmark measures.  Arrays are indexed
``u[i, k, j]`` as in the paper's Fortran; the loops run over the interior,
one point in from every face.  The paper updates ``u`` in place; each
point reads ``u`` only at itself, so the output ``u`` is the interior's
new values.
"""
from repro_torch.core.ir import Scalar, arr, loopnest, program

ARRAYS = ("u", "r")
SCALARS = ("c0", "c1", "c2", "c3")
OUTPUTS = ("u",)
#: points between an array's face and the loop nest's first point
HALO = 1


def array_shape(n: int) -> tuple:
    """The shape of each input array at extent ``n``: an ``n``-cube."""
    return (n, n, n)


def output_shape(n: int) -> tuple:
    """The shape of each output: the interior of an ``n``-cube."""
    return (n - 2 * HALO,) * 3


def build(n: int):
    """``u = u + c0 * r + c1 * (r's 6 face neighbours) + c2 * (its 12 edge
    neighbours) + c3 * (its 8 corners)`` over an ``n``-cube's interior,
    each class summed in the order of its offsets (di, then dk, then dj)."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2),
                                ("i", 1, n - 2))
    u, r = arr("u"), arr("r")
    c = [Scalar(f"c{m}") for m in range(4)]

    def ring(cls):
        acc = None
        for di in (-1, 0, 1):
            for dk in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if (di != 0) + (dk != 0) + (dj != 0) == cls:
                        tap = r[i + di, k + dk, j + dj]
                        acc = tap if acc is None else acc + tap
        return acc

    body = (u[i, k, j] + c[0] * r[i, k, j] + c[1] * ring(1) + c[2] * ring(2)
            + c[3] * ring(3))
    return program(loops, [(u[i, k, j], body)])
