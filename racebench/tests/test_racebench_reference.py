"""The benchmark's plain references against a float64 NumPy loop nest at
small extents: j3d27pt's forward and its gradients (plain autograd through
the reference), and psinv's and poisson's forwards; with and without a
batch axis."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import verdict  # noqa: E402

J = benchspec.module("reference", "j3d27pt")
P = benchspec.module("reference", "psinv")
Q = benchspec.module("reference", "poisson")
REFERENCES = ["j3d27pt", "psinv", "poisson"]
TAPS = [(di, dk, dj) for di in (-1, 0, 1) for dk in (-1, 0, 1)
        for dj in (-1, 0, 1)]


def j3d27pt_loops(u, jc, jnorm):
    n0, n1, n2 = u.shape
    out = np.zeros((n0 - 2, n1 - 2, n2 - 2))
    for i in range(1, n0 - 1):
        for k in range(1, n1 - 1):
            for j in range(1, n2 - 1):
                acc = 0.0
                for di, dk, dj in TAPS:
                    c = (di != 0) + (dk != 0) + (dj != 0)
                    acc += jc[c] * u[i + di, k + dk, j + dj]
                out[i - 1, k - 1, j - 1] = acc / jnorm
    return out


def j3d27pt_grad_loops(u, jc, jnorm, g):
    """Gradients of sum(g * j27) by hand: each tap's cotangent scattered
    back to u, each class's sum of u times g, and -sum(g * j27) / jnorm."""
    n0, n1, n2 = u.shape
    du = np.zeros_like(u)
    djc = np.zeros(4)
    out = j3d27pt_loops(u, jc, jnorm)
    for i in range(1, n0 - 1):
        for k in range(1, n1 - 1):
            for j in range(1, n2 - 1):
                gi = g[i - 1, k - 1, j - 1]
                for di, dk, dj in TAPS:
                    c = (di != 0) + (dk != 0) + (dj != 0)
                    du[i + di, k + dk, j + dj] += gi * jc[c] / jnorm
                    djc[c] += gi * u[i + di, k + dk, j + dj] / jnorm
    return du, djc, -float((g * out).sum()) / jnorm


def psinv_loops(u, r, c):
    n0, n1, n2 = u.shape
    out = np.zeros((n0 - 2, n1 - 2, n2 - 2))
    for i in range(1, n0 - 1):
        for k in range(1, n1 - 1):
            for j in range(1, n2 - 1):
                acc = u[i, k, j]
                for di, dk, dj in TAPS:
                    m = (di != 0) + (dk != 0) + (dj != 0)
                    acc += c[m] * r[i + di, k + dk, j + dj]
                out[i - 1, k - 1, j - 1] = acc
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("shape", [(5, 5, 5), (6, 7, 5)])
def test_j3d27pt_forward_matches_the_loop_nest(shape):
    rng = np.random.default_rng(1)
    u = rng.uniform(-1, 1, shape)
    jc, jnorm = rng.uniform(0.25, 1, 4), rng.uniform(0.25, 1)
    got = J.forward({"u": _t(u)}, {**{f"jc{c}": _t(jc[c]) for c in range(4)},
                                   "jnorm": _t(jnorm)})
    np.testing.assert_allclose(got["j27"].numpy(),
                               j3d27pt_loops(u, jc, jnorm), rtol=1e-13,
                               atol=1e-14)


def test_j3d27pt_backward_by_autograd_matches_the_loop_nest():
    rng = np.random.default_rng(2)
    u = rng.uniform(-1, 1, (6, 5, 7))
    jc, jnorm = rng.uniform(0.25, 1, 4), rng.uniform(0.25, 1)
    g = rng.uniform(-1, 1, (4, 3, 5))
    leaves = {"u": _t(u), **{f"jc{c}": _t(jc[c]) for c in range(4)},
              "jnorm": _t(jnorm)}
    for v in leaves.values():
        v.requires_grad_()
    out = J.forward({"u": leaves["u"]},
                    {k: v for k, v in leaves.items() if k != "u"})
    grads = dict(zip(leaves, torch.autograd.grad(out["j27"],
                                                 list(leaves.values()),
                                                 _t(g))))
    du, djc, djnorm = j3d27pt_grad_loops(u, jc, jnorm, g)
    np.testing.assert_allclose(grads["u"].numpy(), du, rtol=1e-12,
                               atol=1e-13)
    for c in range(4):
        assert float(grads[f"jc{c}"]) == pytest.approx(djc[c], rel=1e-12)
    assert float(grads["jnorm"]) == pytest.approx(djnorm, rel=1e-12)


@pytest.mark.parametrize("shape", [(5, 5, 5), (7, 6, 5)])
def test_psinv_forward_matches_the_loop_nest(shape):
    rng = np.random.default_rng(3)
    u, r = rng.uniform(-1, 1, shape), rng.uniform(-1, 1, shape)
    c = rng.uniform(0.25, 1, 4)
    got = P.forward({"u": _t(u), "r": _t(r)},
                    {f"c{m}": _t(c[m]) for m in range(4)})
    assert set(got) == {"u"}
    np.testing.assert_allclose(got["u"].numpy(), psinv_loops(u, r, c),
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("shape", [(5, 5, 5), (7, 5, 9)])
def test_poisson_forward_matches_the_loop_nest(shape):
    """poisson is j3d27pt's loop nest with the weights (pc0, -pc1, -pc2, 0)
    and no divisor."""
    rng = np.random.default_rng(6)
    u, c = rng.uniform(-1, 1, shape), rng.uniform(0.25, 1, 3)
    got = Q.forward({"u": _t(u)}, {f"pc{m}": _t(c[m]) for m in range(3)})
    assert set(got) == {"pois"}
    np.testing.assert_allclose(got["pois"].numpy(),
                               j3d27pt_loops(u, (c[0], -c[1], -c[2], 0), 1),
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("name", REFERENCES)
def test_a_batch_axis_is_the_examples_one_by_one(name):
    prog = benchspec.module("programs", name)
    ref = benchspec.module("reference", name)
    gen = torch.Generator().manual_seed(4)
    B, n = 3, 8
    arrays = {k: torch.rand((B, n, n, n), generator=gen, dtype=torch.float64)
              for k in prog.ARRAYS}
    scalars = {k: torch.rand((B,), generator=gen, dtype=torch.float64)
               for k in prog.SCALARS}
    got = ref.forward(arrays, scalars)
    for b in range(B):
        one = ref.forward({k: v[b] for k, v in arrays.items()},
                          {k: v[b] for k, v in scalars.items()})
        for k in one:
            torch.testing.assert_close(got[k][b], one[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", REFERENCES)
def test_references_import_nothing_of_the_program(name):
    text = (HERE / "reference" / f"{name}.py").read_text()
    assert "repro" not in text and "jax" not in text


@pytest.mark.parametrize("name", REFERENCES)
def test_the_reference_computes_the_frozen_program(name):
    """At a small extent on the CPU, the port's plain evaluator of the
    frozen loop nest gives the reference's outputs: the two describe one
    stencil."""
    from repro_torch import race

    prog = benchspec.module("programs", name)
    ref = benchspec.module("reference", name)
    n = 9
    gen = torch.Generator().manual_seed(5)
    env = {k: torch.rand((n, n, n), generator=gen, dtype=torch.float64)
           for k in prog.ARRAYS}
    env.update({k: torch.rand((), generator=gen, dtype=torch.float64)
                for k in prog.SCALARS})
    got = race(prog.build(n)).run(env, "torch", device="cpu")
    want = ref.forward({k: env[k] for k in prog.ARRAYS},
                       {k: env[k] for k in prog.SCALARS})
    assert verdict.output_gap(got, want) < 1e-14
