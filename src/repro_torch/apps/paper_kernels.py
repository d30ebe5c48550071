"""Own copy of ``repro/apps/paper_kernels.py`` for the PyTorch port, which imports nothing of
``repro``; ``tests/test_torch_structure.py`` holds the two against drift.

The paper's evaluation kernels (Table 1), expressed in the RACE DSL.

Fidelity tiers (DESIGN.md section 9, item 4):
  * exact      — reconstructed from code the paper prints (POP calc_tpoints
                 from Figs 1-2, mgrid psinv from Fig 6) or from the public
                 NAS MG sources the SPEC2000 mgrid benchmark derives from
                 (resid, rprj3);
  * structural — the computation pattern is standard (5x5 gaussian, 27-point
                 Jacobi, 19-point Poisson) and the expanded form is pinned to
                 the paper's Base op counts;
  * reconstructed — POP hdifft_gm / ocn_export and the WRF kernels: sources
                 are not printed in the paper; we build representative kernels
                 of the same computational character and report our own counts
                 side by side with the paper's.

Loops follow the paper's Fortran ordering (outermost j, then k, innermost i)
but 0-based; arrays are indexed A[i, k, j] like the paper's ``R(i,k,j)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.ir import Program, Scalar, arr, cos, loopnest, program, sin


@dataclass
class Case:
    name: str
    app: str
    program: Program
    reassociate: int = 3
    rewrite_div: bool = False
    fidelity: str = "reconstructed"
    # paper Table 1 row: (reduced_ops, aa_num, alg_iter,
    #                     {op: (base, race_nr, race)})
    paper: dict = field(default_factory=dict)
    # scalar inputs needed by evaluators
    scalars: tuple = ()
    grid3d: bool = False


# ---------------------------------------------------------------------------
# POP
# ---------------------------------------------------------------------------


def pop_calc_tpoints(nx: int = 14, ny: int = 12) -> Case:
    """Fig 1 (left) with the source's scalar temporaries inlined (the temps
    are classic same-iteration CSE; our Base therefore counts 20 sin/cos
    where the paper's counts 16 — round 0 recovers them)."""
    loops, (j, i) = loopnest(("j", 1, ny - 1), ("i", 1, nx - 1))
    ulon, ulat = arr("ulon"), arr("ulat")
    tx, ty, tz = arr("tx"), arr("ty"), arr("tz")
    p25 = Scalar("p25")

    def term(f, g, di, dj):
        return f(ulon[i + di, j + dj]) * g(ulat[i + di, j + dj])

    def foursum(t):
        return ((t(0, 0) + t(0, -1)) + t(-1, 0)) + t(-1, -1)

    xsum = foursum(lambda di, dj: term(cos, cos, di, dj))
    ysum = foursum(lambda di, dj: term(sin, cos, di, dj))
    zsum = foursum(lambda di, dj: sin(ulat[i + di, j + dj]))
    prog = program(loops, [
        (tx[i, j], p25 * xsum),
        (ty[i, j], p25 * ysum),
        (tz[i, j], p25 * zsum),
    ])
    return Case(
        "calc_tpoints", "POP", prog, reassociate=3, fidelity="exact",
        paper=dict(reduced=0.55, aa=9, iters=3,
                   ops={"add": (9, 9, 6), "mul": (11, 5, 5), "sincos": (16, 4, 4)}),
        scalars=("p25",),
    )


def pop_hdifft_gm(nx: int = 14, ny: int = 12) -> Case:
    """Reconstructed Gent-McWilliams tracer-diffusion partial sums: two
    staggered 2x2 box sums per tracer reused across i and j (adds only,
    like the paper's row)."""
    loops, (j, i) = loopnest(("j", 1, ny - 2), ("i", 1, nx - 2))
    T, S = arr("T"), arr("S")
    dn, ds = arr("dn"), arr("dso")

    def box(A, dj):
        return (A[i, j + dj] + A[i + 1, j + dj]) + (A[i, j + dj + 1] + A[i + 1, j + dj + 1])

    prog = program(loops, [
        (dn[i, j], box(T, 0) + box(S, 0)),
        (ds[i, j], box(T, -1) + box(S, -1)),
    ])
    return Case(
        "hdifft_gm", "POP", prog, reassociate=3,
        paper=dict(reduced=0.63, aa=2, iters=1, ops={"add": (14, 11, 4)}),
    )


def pop_ocn_export(nx: int = 14, ny: int = 12) -> Case:
    """Reconstructed rotated-velocity export: u/v rotated through the grid
    angle and scaled — sin/cos of the same angle used by both statements,
    a shared quotient for the divisions."""
    loops, (j, i) = loopnest(("j", 0, ny - 1), ("i", 0, nx - 1))
    u, v, ang, m = arr("u"), arr("v"), arr("ang"), arr("m")
    ue, vn = arr("ue"), arr("vn")
    c = Scalar("c")
    prog = program(loops, [
        (ue[i, j], (u[i, j] * cos(ang[i, j]) - v[i, j] * sin(ang[i, j])) * (c / m[i, j])),
        (vn[i, j], (u[i, j] * sin(ang[i, j]) + v[i, j] * cos(ang[i, j])) * (c / m[i, j])),
    ])
    return Case(
        "ocn_export", "POP", prog, reassociate=3, rewrite_div=False,
        paper=dict(reduced=0.17, aa=2, iters=1,
                   ops={"add": (1, 1, 1), "sub": (1, 1, 1), "mul": (6, 6, 5),
                        "div": (2, 2, 1), "sincos": (4, 2, 2)}),
        scalars=("c",),
    )


# ---------------------------------------------------------------------------
# WRF (reconstructed)
# ---------------------------------------------------------------------------


def wrf_rhs_ph(variant: int, n: int = 10) -> Case:
    """Reconstructed geopotential-tendency RHS: advection of ph by staggered
    winds with map factors; variant 2 shifts the vertical coupling."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    ph, u, w, mu, mub = arr("ph"), arr("u"), arr("w"), arr("mu"), arr("mub")
    msft, rdnw = arr("msft"), arr("rdnw")
    out = arr(f"ph_t{variant}")
    rdx = Scalar("rdx")
    dk = 1 if variant == 2 else 0

    adv_x = (u[i, k, j] + u[i + 1, k, j]) * (ph[i + 1, k + dk, j] - ph[i - 1, k + dk, j]) * rdx
    adv_x2 = (u[i, k + 1, j] + u[i + 1, k + 1, j]) * (ph[i + 1, k + 1 + dk, j] - ph[i - 1, k + 1 + dk, j]) * rdx
    vert = w[i, k, j] * (ph[i, k + 1, j] - ph[i, k - 1, j]) * rdnw[k]
    vert2 = w[i, k + 1, j] * (ph[i, k + 2, j] - ph[i, k, j]) * rdnw[k + 1]
    scale = (mu[i, j] + mub[i, j]) / msft[i, j]
    body = (adv_x + adv_x2) - (vert + vert2) - scale * (ph[i, k, j] - ph[i, k - 1, j]) / msft[i, j]
    prog = program(loops, [(out[i, k, j], body)])
    paper_rows = {
        1: dict(reduced=0.06, aa=3, iters=2,
                ops={"add": (6, 5, 5), "sub": (9, 9, 9), "mul": (12, 10, 10), "div": (2, 2, 2)}),
        2: dict(reduced=0.16, aa=3, iters=2,
                ops={"add": (6, 5, 5), "sub": (9, 9, 9), "mul": (12, 10, 10), "div": (2, 2, 2)}),
    }
    return Case(f"rhs_ph{variant}", "WRF", prog, reassociate=3,
                paper=paper_rows[variant], scalars=("rdx",), grid3d=True)


def wrf_diffusion(variant: int, n: int = 10) -> Case:
    """Reconstructed flux-form variable-coefficient diffusion.  The flux at
    face i equals the flux at face i+1 of the previous iteration — the
    classic loop-carried redundancy RACE targets; map-factor divisions give
    the div column."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    T, K, m, dx = arr("T"), arr("Kd"), arr("mf"), arr("dxa")
    out = arr(f"diff{variant}")
    dt = Scalar("dt")

    def flux(di, dk, dj):
        # (K(x)+K(x+e))*(T(x+e)-T(x)) at face offset (di,dk,dj)
        return (K[i + di, k + dk, j + dj] + K[i + di + (1 if dk == dj == 0 else 0),
                                             k + dk + (1 if di == dj == 0 else 0),
                                             j + dj + (1 if di == dk == 0 else 0)]) * (
            T[i + di + (1 if dk == dj == 0 else 0),
              k + dk + (1 if di == dj == 0 else 0),
              j + dj + (1 if di == dk == 0 else 0)] - T[i + di, k + dk, j + dj])

    fx = (flux(0, 0, 0) - flux(-1, 0, 0)) * (m[i, j] / dx[i, j])
    fk = (flux(0, 0, 0) - flux(0, -1, 0)) * (m[i, j] / dx[i, j])
    fj = (flux(0, 0, 0) - flux(0, 0, -1)) * (m[i, j] / dx[i, j])
    if variant == 1:
        body = T[i, k, j] + dt * ((fx + fk) + fj)
    elif variant == 2:
        body = T[i, k, j] + dt * ((fx + fj) + fk) + dt * (m[i, j] / dx[i, j]) * (
            T[i + 1, k, j] - (T[i, k, j] + T[i, k, j]) + T[i - 1, k, j])
    else:
        body = T[i, k, j] + (dt * (m[i, j] / dx[i, j])) * (
            (flux(0, 0, 0) - flux(-1, 0, 0))
            + (flux(0, 0, 0) - flux(0, -1, 0))
            + (flux(0, 0, 0) - flux(0, 0, -1)))
    prog = program(loops, [(out[i, k, j], body)])
    rows = {
        1: dict(reduced=0.44, aa=20, iters=5,
                ops={"add": (18, 18, 8), "sub": (6, 4, 4), "mul": (26, 21, 15), "div": (4, 3, 2)}),
        2: dict(reduced=0.60, aa=19, iters=5,
                ops={"add": (18, 16, 8), "sub": (6, 4, 4), "mul": (26, 20, 14), "div": (4, 3, 2)}),
        3: dict(reduced=0.49, aa=19, iters=6,
                ops={"add": (10, 6, 6), "sub": (6, 4, 4), "mul": (32, 18, 17), "div": (2, 1, 1)}),
    }
    return Case(f"diffusion{variant}", "WRF", prog, reassociate=4,
                paper=rows[variant], scalars=("dt",), grid3d=True)


# ---------------------------------------------------------------------------
# mgrid (SPEC2000 / NAS MG)
# ---------------------------------------------------------------------------


def _stencil27(u, i, k, j, cls):
    """27-point neighbor sums split by symmetry class (faces/edges/corners)."""
    faces, edges, corners = [], [], []
    for di in (-1, 0, 1):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                nz = (di != 0) + (dk != 0) + (dj != 0)
                if nz == cls:
                    yield u[i + di, k + dk, j + dj]


def _sum(terms):
    terms = list(terms)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def mgrid_psinv(n: int = 10) -> Case:
    """Fig 6 (left): exact."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    U, R = arr("U"), arr("R")
    w0, w1, w2, w3 = (Scalar(s) for s in ("w0", "w1", "w2", "w3"))
    body = (
        U[i, k, j]
        + w0 * R[i, k, j]
        + w1 * _sum(_stencil27(R, i, k, j, 1))
        + w2 * _sum(_stencil27(R, i, k, j, 2))
        + w3 * _sum(_stencil27(R, i, k, j, 3))
    )
    prog = program(loops, [(U[i, k, j], body)])
    return Case(
        "psinv", "mgrid", prog, reassociate=4, fidelity="exact",
        paper=dict(reduced=0.38, aa=9, iters=3,
                   ops={"add": (27, 23, 13), "mul": (4, 4, 6)}),
        scalars=("w0", "w1", "w2", "w3"), grid3d=True,
    )


def mgrid_resid(n: int = 10) -> Case:
    """NAS MG resid with the hand-buffered u1/u2 temporaries expanded."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    V, U, R = arr("V"), arr("U"), arr("Rr")
    a0, a1, a2, a3 = (Scalar(s) for s in ("a0", "a1", "a2", "a3"))
    body = (
        V[i, k, j]
        - a0 * U[i, k, j]
        - a1 * _sum(_stencil27(U, i, k, j, 1))
        - a2 * _sum(_stencil27(U, i, k, j, 2))
        - a3 * _sum(_stencil27(U, i, k, j, 3))
    )
    prog = program(loops, [(R[i, k, j], body)])
    return Case(
        "resid", "mgrid", prog, reassociate=4, fidelity="exact",
        paper=dict(reduced=0.45, aa=4, iters=3,
                   ops={"add": (23, 19, 11), "sub": (4, 4, 4), "mul": (4, 4, 4)}),
        scalars=("a0", "a1", "a2", "a3"), grid3d=True,
    )


def mgrid_rprj3(n: int = 10) -> Case:
    """NAS MG restriction: stride-2 fine-grid references (the paper's
    demonstration that rpi handles coefficient-2 subscripts)."""
    nc = n // 2 - 1
    loops, (j, k, i) = loopnest(("j", 1, nc - 1), ("k", 1, nc - 1), ("i", 1, nc - 1))
    Rf, S = arr("Rf"), arr("S")
    c0, c1, c2, c3 = (Scalar(s) for s in ("c0", "c1", "c2", "c3"))

    def f(di, dk, dj):
        return Rf[2 * i + di, 2 * k + dk, 2 * j + dj]

    def cls_sum(cls):
        return _sum(
            f(di, dk, dj)
            for di in (-1, 0, 1)
            for dk in (-1, 0, 1)
            for dj in (-1, 0, 1)
            if (di != 0) + (dk != 0) + (dj != 0) == cls
        )

    body = c0 * f(0, 0, 0) + c1 * cls_sum(1) + c2 * cls_sum(2) + c3 * cls_sum(3)
    prog = program(loops, [(S[i, k, j], body)])
    return Case(
        "rprj3", "mgrid", prog, reassociate=4, fidelity="exact",
        paper=dict(reduced=0.19, aa=5, iters=2,
                   ops={"add": (26, 26, 20), "mul": (4, 4, 4)}),
        scalars=("c0", "c1", "c2", "c3"), grid3d=True,
    )


# ---------------------------------------------------------------------------
# stencil kernels
# ---------------------------------------------------------------------------


def stencil_gaussian(n: int = 500) -> Case:
    """5x5 gaussian blur, one product per tap (Base: add 24, mul 25, div 1)."""
    loops, (j, i) = loopnest(("j", 2, n - 3), ("i", 2, n - 3))
    u, out = arr("u"), arr("gb")
    ws = {c: Scalar(f"g{c}") for c in range(6)}
    norm = Scalar("gnorm")

    def cls(di, dj):
        key = tuple(sorted((abs(di), abs(dj))))
        return {(0, 0): 0, (0, 1): 1, (1, 1): 2, (0, 2): 3, (1, 2): 4, (2, 2): 5}[key]

    terms = [
        ws[cls(di, dj)] * u[i + di, j + dj]
        for di in range(-2, 3)
        for dj in range(-2, 3)
    ]
    prog = program(loops, [(out[i, j], _sum(terms) / norm)])
    return Case(
        "gaussian", "stencil", prog, reassociate=3, fidelity="structural",
        paper=dict(reduced=0.43, aa=13, iters=4,
                   ops={"add": (24, 24, 16), "mul": (25, 6, 11), "div": (1, 1, 1)}),
        scalars=tuple(f"g{c}" for c in range(6)) + ("gnorm",),
    )


def stencil_j3d27pt(n: int = 100) -> Case:
    """27-point Jacobi, one product per tap (Base: add 26, mul 27, div 1)."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    u, out = arr("u"), arr("j27")
    cw = {c: Scalar(f"jc{c}") for c in range(4)}
    norm = Scalar("jnorm")
    terms = [
        cw[(di != 0) + (dk != 0) + (dj != 0)] * u[i + di, k + dk, j + dj]
        for di in (-1, 0, 1)
        for dk in (-1, 0, 1)
        for dj in (-1, 0, 1)
    ]
    prog = program(loops, [(out[i, k, j], _sum(terms) / norm)])
    return Case(
        "j3d27pt", "stencil", prog, reassociate=3, fidelity="structural",
        paper=dict(reduced=0.35, aa=20, iters=3,
                   ops={"add": (26, 26, 18), "mul": (27, 15, 15), "div": (1, 1, 1)}),
        scalars=tuple(f"jc{c}" for c in range(4)) + ("jnorm",), grid3d=True,
    )


def stencil_poisson(n: int = 100) -> Case:
    """19-point Poisson relaxation, factored weights (Base: add 16, sub 2, mul 3)."""
    loops, (j, k, i) = loopnest(("j", 1, n - 2), ("k", 1, n - 2), ("i", 1, n - 2))
    u, f, out = arr("u"), arr("fp"), arr("pois")
    c0, c1, c2 = Scalar("pc0"), Scalar("pc1"), Scalar("pc2")
    body = (f[i, k, j] - c0 * u[i, k, j]) - (
        c1 * _sum(_stencil27(u, i, k, j, 1)) + c2 * _sum(_stencil27(u, i, k, j, 2))
    )
    prog = program(loops, [(out[i, k, j], body)])
    return Case(
        "poisson", "stencil", prog, reassociate=4, fidelity="structural",
        paper=dict(reduced=0.37, aa=3, iters=2,
                   ops={"add": (16, 15, 8), "sub": (2, 2, 2), "mul": (3, 3, 3)}),
        scalars=("pc0", "pc1", "pc2"), grid3d=True,
    )


def stencil_derivative(n: int = 100) -> Case:
    """Reconstructed high-order product-rule derivative battery: 4th-order
    centered d/d{x,k,j} of the pairwise products uv, uw, vw — the shifted
    products u*v are the massive shared redundancy (paper: 297 -> 76 muls)."""
    loops, (j, k, i) = loopnest(("j", 2, n - 3), ("k", 2, n - 3), ("i", 2, n - 3))
    u, v, w = arr("du"), arr("dv"), arr("dw")
    c1, c2 = Scalar("dc1"), Scalar("dc2")
    outs = []

    def pair_prod(A, B, di, dk, dj):
        return A[i + di, k + dk, j + dj] * B[i + di, k + dk, j + dj]

    for pname, (A, B) in {"uv": (u, v), "uw": (u, w), "vw": (v, w)}.items():
        for dname, (ei, ek, ej) in {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}.items():
            d1 = pair_prod(A, B, ei, ek, ej) - pair_prod(A, B, -ei, -ek, -ej)
            d2 = pair_prod(A, B, 2 * ei, 2 * ek, 2 * ej) - pair_prod(
                A, B, -2 * ei, -2 * ek, -2 * ej)
            outs.append((arr(f"d_{pname}_{dname}")[i, k, j], c1 * d1 - c2 * d2))
    prog = program(loops, outs)
    return Case(
        "derivative", "stencil", prog, reassociate=4,
        paper=dict(reduced=0.71, aa=86, iters=11,
                   ops={"add": (99, 54, 45), "sub": (96, 24, 16), "mul": (297, 101, 76)}),
        scalars=("dc1", "dc2"), grid3d=True,
    )


# ---------------------------------------------------------------------------
# envelope kernels (not in the paper's Table 1)
# ---------------------------------------------------------------------------
#
# These four cases pin the *closed capability envelope* of the
# dimension-generic lowering engine (``repro.lowering``): each exercises one
# mechanism that used to be a structural Pallas fallback — 1-D and 4-D nest
# depth (N-D grid construction), negative coefficients (mirrored-origin
# windows), repeated levels (in-kernel index gather).  They carry no paper
# row (``paper={}``) and stay out of TABLE1_ORDER, but are full registry
# members: the differential harness sweeps them against both backends like
# every Table 1 case.


def envelope_smooth1d(n: int = 40) -> Case:
    """1-D two-pass box smoothing: the 3-point partial sum is reused at two
    shifts — the depth-1 twin of hdifft_gm's staggered box sums."""
    loops, (i,) = loopnest(("i", 2, n - 3))
    u, out = arr("u"), arr("sm1")
    ws = Scalar("ws")

    def s3(d):
        return (u[i + d - 1] + u[i + d]) + u[i + d + 1]

    prog = program(loops, [(out[i], ws * (s3(0) + s3(-1)))])
    return Case("smooth1d", "envelope", prog, reassociate=3,
                fidelity="structural", scalars=("ws",))


def envelope_blocked4d(n: int = 8) -> Case:
    """4-D blocked tensor update: per-(j,i) face sums coupling consecutive
    depth slices, reused across a j shift — a batched-stencil shape whose
    depth-4 nest previously fell back to XLA."""
    loops, (h, d, j, i) = loopnest(("h", 1, n - 2), ("d", 1, n - 2),
                                   ("j", 1, n - 2), ("i", 1, n - 2))
    T, out = arr("T4"), arr("o4")
    dt = Scalar("dt4")

    def face(dj, di):
        return T[h, d, j + dj, i + di] + T[h, d + 1, j + dj, i + di]

    def box(dj):
        return face(dj, 0) + face(dj, 1)

    prog = program(loops, [(out[h, d, j, i],
                            T[h, d, j, i] + dt * (box(0) + box(-1)))])
    return Case("blocked4d", "envelope", prog, reassociate=3,
                fidelity="structural", scalars=("dt4",))


def envelope_mirror_deriv(n: int = 40) -> Case:
    """Mirrored-derivative: 4th-order centered derivative (along j) of a
    mirrored 2-point pair sum ``u[M-i, .] + u[M-1-i, .]`` — every reference
    carries a negative level-1 coefficient, lowered via the engine's
    mirrored-origin windows."""
    loops, (i, j) = loopnest(("i", 1, n - 2), ("j", 2, n - 3))
    u, out = arr("u"), arr("md")
    c1, c2 = Scalar("mc1"), Scalar("mc2")
    M = n - 1

    def pair(dj):
        return u[-i + M, j + dj] + u[-i + (M - 1), j + dj]

    prog = program(loops, [
        (out[i, j], c1 * (pair(1) - pair(-1)) - c2 * (pair(2) - pair(-2)))])
    return Case("mirror_deriv", "envelope", prog, reassociate=3,
                fidelity="structural", scalars=("mc1", "mc2"))


def envelope_diag2d(n: int = 40) -> Case:
    """Repeated-level diagonal scaling: ``g[i, i]`` reads the diagonal of a
    coupling matrix inside a j-shifted product chain — the ``a[i][i]`` class
    lowered via the engine's in-kernel index gather."""
    loops, (i, j) = loopnest(("i", 1, n - 2), ("j", 1, n - 2))
    g, u, out = arr("gd"), arr("u"), arr("dg2")

    def t(dj):
        return g[i, i] * u[i, j + dj]

    prog = program(loops, [(out[i, j], (t(-1) + t(0)) + t(1))])
    return Case("diag2d", "envelope", prog, reassociate=3,
                fidelity="structural")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

CASES: dict = {}


def _register(fn: Callable, *args, **kw):
    case = fn(*args, **kw)
    CASES[case.name] = (fn, args, kw)
    return case


for _f in (pop_hdifft_gm, pop_calc_tpoints, pop_ocn_export):
    _register(_f)
_register(wrf_rhs_ph, 1)
_register(wrf_rhs_ph, 2)
for _v in (1, 2, 3):
    _register(wrf_diffusion, _v)
for _f in (mgrid_psinv, mgrid_resid, mgrid_rprj3,
           stencil_gaussian, stencil_j3d27pt, stencil_poisson, stencil_derivative):
    _register(_f)
for _f in (envelope_smooth1d, envelope_blocked4d, envelope_mirror_deriv,
           envelope_diag2d):
    _register(_f)

TABLE1_ORDER = [
    "hdifft_gm", "calc_tpoints", "ocn_export", "rhs_ph1", "rhs_ph2",
    "diffusion1", "diffusion2", "diffusion3", "psinv", "resid", "rprj3",
    "gaussian", "j3d27pt", "poisson", "derivative",
]


def get_case(name: str, n: Optional[int] = None, via: str = "dsl") -> Case:
    """Build a registry case.

    ``via="dsl"`` returns the hand-built program; ``via="frontend"`` routes
    through the plain-Python twin in ``repro_torch.apps.frontend_kernels`` —
    the program is captured from ordinary Python source by
    ``repro_torch.frontend`` and checked identical to the hand-built one
    (KeyError when the case has no twin yet).
    """
    if via not in ("dsl", "frontend"):
        raise ValueError(f"unknown via {via!r}; choose 'dsl' or 'frontend'")
    fn, args, kw = CASES[name]
    if n is None:
        case = fn(*args, **kw)
    elif args:
        case = fn(*args, n)
    else:
        # 2-D builders take (nx, ny) or (n)
        try:
            case = fn(n)
        except TypeError:
            case = fn(n, n)
    if via == "frontend":
        from .frontend_kernels import as_frontend

        case = as_frontend(case)
    return case
