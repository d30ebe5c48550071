"""Own copy of ``repro/apps/frontend_kernels.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_frontend.py`` holds the
two against drift.

Plain-Python twins of registry kernels for the capture frontend.

Each function here is an ordinary Python loop nest — no DSL, no IR — that
re-expresses a case from ``paper_kernels``.  ``as_frontend`` captures the
twin with ``repro_torch.frontend.capture`` and checks it reproduces the
hand-built :class:`Program` *exactly* (dataclass equality: same loops, same
expression trees, same association order), so the whole pipeline behind it
— detection plan, ``reduced_ops``, backend lowering — is provably identical
to the curated entry path.

Loop bounds are read off the input array shapes (``n = R.shape[0]``), the
way a NumPy user would write the kernel; the shapes handed to ``capture``
come from ``required_shapes`` of the hand-built program, which pins the
same iteration space.  Association order is load-bearing: the binary
detector hashes the trees as written, so the twins spell out neighbor sums
in the same (di, dk, dj) iteration order as the DSL builders.
"""
from __future__ import annotations

from dataclasses import replace
from math import cos, sin

from ..core.codegen import required_shapes

# ---------------------------------------------------------------------------
# POP
# ---------------------------------------------------------------------------


def calc_tpoints(ulon, ulat, tx, ty, tz, p25):
    """Paper Fig 1 (left), temps inlined — twin of ``pop_calc_tpoints``."""
    nx, ny = ulon.shape
    for j in range(1, ny):
        for i in range(1, nx):
            tx[i, j] = p25 * (cos(ulon[i, j]) * cos(ulat[i, j])
                              + cos(ulon[i, j - 1]) * cos(ulat[i, j - 1])
                              + cos(ulon[i - 1, j]) * cos(ulat[i - 1, j])
                              + cos(ulon[i - 1, j - 1]) * cos(ulat[i - 1, j - 1]))
            ty[i, j] = p25 * (sin(ulon[i, j]) * cos(ulat[i, j])
                              + sin(ulon[i, j - 1]) * cos(ulat[i, j - 1])
                              + sin(ulon[i - 1, j]) * cos(ulat[i - 1, j])
                              + sin(ulon[i - 1, j - 1]) * cos(ulat[i - 1, j - 1]))
            tz[i, j] = p25 * (sin(ulat[i, j])
                              + sin(ulat[i, j - 1])
                              + sin(ulat[i - 1, j])
                              + sin(ulat[i - 1, j - 1]))


def hdifft_gm(T, S, dn, dso):
    """Staggered 2x2 box sums — twin of ``pop_hdifft_gm``."""
    nx, ny = T.shape
    for j in range(1, ny - 1):
        for i in range(1, nx - 1):
            dn[i, j] = ((T[i, j] + T[i + 1, j]) + (T[i, j + 1] + T[i + 1, j + 1])) \
                + ((S[i, j] + S[i + 1, j]) + (S[i, j + 1] + S[i + 1, j + 1]))
            dso[i, j] = ((T[i, j - 1] + T[i + 1, j - 1]) + (T[i, j] + T[i + 1, j])) \
                + ((S[i, j - 1] + S[i + 1, j - 1]) + (S[i, j] + S[i + 1, j]))


# ---------------------------------------------------------------------------
# mgrid (the 27-point symmetry-class sums; neighbor order matches
# ``paper_kernels._stencil27``: di, then dk, then dj, each in (-1, 0, 1))
# ---------------------------------------------------------------------------


def psinv(U, R, w0, w1, w2, w3):
    """Paper Fig 6 (left) — twin of ``mgrid_psinv``."""
    n = R.shape[0]
    for j in range(1, n - 1):
        for k in range(1, n - 1):
            for i in range(1, n - 1):
                U[i, k, j] = (U[i, k, j]
                              + w0 * R[i, k, j]
                              + w1 * (R[i - 1, k, j] + R[i, k - 1, j]
                                      + R[i, k, j - 1] + R[i, k, j + 1]
                                      + R[i, k + 1, j] + R[i + 1, k, j])
                              + w2 * (R[i - 1, k - 1, j] + R[i - 1, k, j - 1]
                                      + R[i - 1, k, j + 1] + R[i - 1, k + 1, j]
                                      + R[i, k - 1, j - 1] + R[i, k - 1, j + 1]
                                      + R[i, k + 1, j - 1] + R[i, k + 1, j + 1]
                                      + R[i + 1, k - 1, j] + R[i + 1, k, j - 1]
                                      + R[i + 1, k, j + 1] + R[i + 1, k + 1, j])
                              + w3 * (R[i - 1, k - 1, j - 1] + R[i - 1, k - 1, j + 1]
                                      + R[i - 1, k + 1, j - 1] + R[i - 1, k + 1, j + 1]
                                      + R[i + 1, k - 1, j - 1] + R[i + 1, k - 1, j + 1]
                                      + R[i + 1, k + 1, j - 1] + R[i + 1, k + 1, j + 1]))


def resid(V, U, Rr, a0, a1, a2, a3):
    """NAS MG residual, hand buffers expanded — twin of ``mgrid_resid``."""
    n = U.shape[0]
    for j in range(1, n - 1):
        for k in range(1, n - 1):
            for i in range(1, n - 1):
                Rr[i, k, j] = (V[i, k, j]
                               - a0 * U[i, k, j]
                               - a1 * (U[i - 1, k, j] + U[i, k - 1, j]
                                       + U[i, k, j - 1] + U[i, k, j + 1]
                                       + U[i, k + 1, j] + U[i + 1, k, j])
                               - a2 * (U[i - 1, k - 1, j] + U[i - 1, k, j - 1]
                                       + U[i - 1, k, j + 1] + U[i - 1, k + 1, j]
                                       + U[i, k - 1, j - 1] + U[i, k - 1, j + 1]
                                       + U[i, k + 1, j - 1] + U[i, k + 1, j + 1]
                                       + U[i + 1, k - 1, j] + U[i + 1, k, j - 1]
                                       + U[i + 1, k, j + 1] + U[i + 1, k + 1, j])
                               - a3 * (U[i - 1, k - 1, j - 1] + U[i - 1, k - 1, j + 1]
                                       + U[i - 1, k + 1, j - 1] + U[i - 1, k + 1, j + 1]
                                       + U[i + 1, k - 1, j - 1] + U[i + 1, k - 1, j + 1]
                                       + U[i + 1, k + 1, j - 1] + U[i + 1, k + 1, j + 1]))


# ---------------------------------------------------------------------------
# stencils
# ---------------------------------------------------------------------------


def j3d27pt(u, j27, jc0, jc1, jc2, jc3, jnorm):
    """27-point Jacobi, one product per tap — twin of ``stencil_j3d27pt``
    (terms in lexicographic (di, dk, dj) order like the DSL builder)."""
    n = u.shape[0]
    for j in range(1, n - 1):
        for k in range(1, n - 1):
            for i in range(1, n - 1):
                j27[i, k, j] = (jc3 * u[i - 1, k - 1, j - 1]
                                + jc2 * u[i - 1, k - 1, j]
                                + jc3 * u[i - 1, k - 1, j + 1]
                                + jc2 * u[i - 1, k, j - 1]
                                + jc1 * u[i - 1, k, j]
                                + jc2 * u[i - 1, k, j + 1]
                                + jc3 * u[i - 1, k + 1, j - 1]
                                + jc2 * u[i - 1, k + 1, j]
                                + jc3 * u[i - 1, k + 1, j + 1]
                                + jc2 * u[i, k - 1, j - 1]
                                + jc1 * u[i, k - 1, j]
                                + jc2 * u[i, k - 1, j + 1]
                                + jc1 * u[i, k, j - 1]
                                + jc0 * u[i, k, j]
                                + jc1 * u[i, k, j + 1]
                                + jc2 * u[i, k + 1, j - 1]
                                + jc1 * u[i, k + 1, j]
                                + jc2 * u[i, k + 1, j + 1]
                                + jc3 * u[i + 1, k - 1, j - 1]
                                + jc2 * u[i + 1, k - 1, j]
                                + jc3 * u[i + 1, k - 1, j + 1]
                                + jc2 * u[i + 1, k, j - 1]
                                + jc1 * u[i + 1, k, j]
                                + jc2 * u[i + 1, k, j + 1]
                                + jc3 * u[i + 1, k + 1, j - 1]
                                + jc2 * u[i + 1, k + 1, j]
                                + jc3 * u[i + 1, k + 1, j + 1]) / jnorm


def poisson(u, fp, pois, pc0, pc1, pc2):
    """19-point Poisson relaxation — twin of ``stencil_poisson``."""
    n = u.shape[0]
    for j in range(1, n - 1):
        for k in range(1, n - 1):
            for i in range(1, n - 1):
                pois[i, k, j] = (fp[i, k, j] - pc0 * u[i, k, j]) - (
                    pc1 * (u[i - 1, k, j] + u[i, k - 1, j]
                           + u[i, k, j - 1] + u[i, k, j + 1]
                           + u[i, k + 1, j] + u[i + 1, k, j])
                    + pc2 * (u[i - 1, k - 1, j] + u[i - 1, k, j - 1]
                             + u[i - 1, k, j + 1] + u[i - 1, k + 1, j]
                             + u[i, k - 1, j - 1] + u[i, k - 1, j + 1]
                             + u[i, k + 1, j - 1] + u[i, k + 1, j + 1]
                             + u[i + 1, k - 1, j] + u[i + 1, k, j - 1]
                             + u[i + 1, k, j + 1] + u[i + 1, k + 1, j]))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: case name -> plain-Python twin
TWINS = {
    "calc_tpoints": calc_tpoints,
    "hdifft_gm": hdifft_gm,
    "psinv": psinv,
    "resid": resid,
    "j3d27pt": j3d27pt,
    "poisson": poisson,
}


def as_frontend(case, check: bool = True):
    """Rebuild ``case`` with its program captured from the Python twin.

    With ``check`` (default) the captured program must equal the hand-built
    one exactly — the frontend acceptance criterion — so downstream plans
    and op counts are identical by construction.
    """
    fn = TWINS.get(case.name)
    if fn is None:
        raise KeyError(
            f"no plain-Python twin for case {case.name!r}; "
            f"available: {sorted(TWINS)}")
    from ..frontend import capture

    prog = capture(fn, required_shapes(case.program))
    if check and prog != case.program:
        raise ValueError(
            f"frontend twin of {case.name!r} diverged from the hand-built "
            f"DSL program")
    return replace(case, program=prog)
