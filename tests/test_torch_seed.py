"""F7: the port's plans do not follow ``PYTHONHASHSEED``; the reference's do.

RACE's n-ary detection breaks MIS degree ties by set iteration order, and a
color vertex ``("color", eri_key)`` sits in a set where its string hash
puts it.  The reference therefore derives another plan for some programs
under some seeds.  The port's color vertices hash as they would under
seed 0 (``repro_torch.core.pairgraph.ColorVertex``), so it derives the
reference's seed-0 plan in every process.

This module also holds what the parity tests need for that: the reference's
structure records, computed in-process or, for the (case, level) pairs and
adjoint specs whose reference plan follows the seed, in one subprocess per
test module under ``PYTHONHASHSEED=0`` (:func:`reference_under_seed0`).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch
from repro_torch.core import pairgraph

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]

#: (case, reassociate level) pairs whose reference plan differs from its
#: seed-0 plan under some PYTHONHASHSEED in 0-59, at every grid size tried
#: (the test sizes, 12 and 64); levels 0-5 and every case's default tried
SEED_DEPENDENT_PLANS = frozenset(
    [("j3d27pt", lvl) for lvl in (1, 2, 3, 4, 5)]
    + [("rprj3", lvl) for lvl in (1, 2, 3)])
#: (case, spec index) adjoint specs at the sweep sizes whose reference plan
#: follows the seed in the same scan
SEED_DEPENDENT_SPECS = frozenset([
    ("blocked4d", 0), ("diffusion1", 0), ("diffusion2", 0),
    ("diffusion3", 1), ("j3d27pt", 2), ("j3d27pt", 4), ("poisson", 3),
    ("psinv", 4), ("resid", 4)])

#: the telemetry keys that identify a plan
PLAN_KEYS = ("program", "plan", "reduced_ops", "n_aux", "n_aux_materialized",
             "rounds")


def ref_plan_record(name: str, n: int, level: int, via: str = "dsl") -> dict:
    """The reference's structure of ``race(get_case(name, n, via).program,
    reassociate=level, rewrite_div=case.rewrite_div)``."""
    from repro.apps.paper_kernels import get_case
    from repro.core.executor import plan_hash
    from repro.core.race import race

    case = get_case(name, n, via=via)
    res = race(case.program, reassociate=level, rewrite_div=case.rewrite_div)
    cap = res.capability()
    tel = res.telemetry()
    return dict(plan_hash=plan_hash(res.plan), reduced_ops=res.reduced_ops(),
                n_aux=res.n_aux(), n_aux_materialized=res.n_aux_materialized(),
                eligible=cap.eligible, reasons=[r.code for r in cap.reasons],
                facts=[f.code for f in cap.facts], to_source=res.to_source(),
                telemetry={k: tel[k] for k in PLAN_KEYS})


def ref_spec_records(name: str, n: int) -> list:
    """Per adjoint spec of the reference: its plan hash and the codes of
    ``analyze_plan`` on that plan."""
    from repro.apps.paper_kernels import get_case
    from repro.core import adjoint
    from repro.core.executor import plan_hash
    from repro.lowering import analyze_plan

    out = []
    for spec in adjoint.adjoint_build(get_case(name, n).program).specs:
        plan = spec.result().plan
        out.append(dict(plan_hash=plan_hash(plan),
                        codes=[r.code for r in analyze_plan(plan).reasons]))
    return out


def _records(requests: list) -> list:
    return [ref_plan_record(*r[1:]) if r[0] == "plan"
            else ref_spec_records(*r[1:]) for r in requests]


def _env(seed: str) -> dict:
    return dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                            str(ROOT / "tests")]))


def reference_under_seed0(requests: list) -> dict:
    """``{request: record}`` from one fresh process under
    ``PYTHONHASHSEED=0``; a request is ``("plan", name, n, level[, via])``
    (a :func:`ref_plan_record`) or ``("specs", name, n)`` (the
    :func:`ref_spec_records` list)."""
    requests = [tuple(r) for r in requests]
    if not requests:
        return {}
    code = ("import json, sys\nimport test_torch_seed as m\n"
            "json.dump(m._records(json.load(sys.stdin)), sys.stdout)")
    proc = subprocess.run([sys.executable, "-c", code], env=_env("0"),
                          input=json.dumps(requests), capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(zip(requests, json.loads(proc.stdout)))


# ---------------------------------------------------------------------------
# the repair
# ---------------------------------------------------------------------------


_PORT_HASH = """
from repro_torch.apps import get_case
from repro_torch.core.executor import plan_hash
from repro_torch.core.race import race
print(plan_hash(race(get_case("j3d27pt", 64).program, reassociate=3).plan))
"""


def test_one_plan_under_every_hash_seed():
    """j3d27pt n=64 at reassociate=3 (the reference derives another plan
    under seed 4): the port gives the reference's seed-0 plan hash under
    every seed 0-5, each in its own process."""
    procs = {s: subprocess.Popen([sys.executable, "-c", _PORT_HASH],
                                 env=_env(str(s)), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for s in range(6)}
    want = reference_under_seed0([("plan", "j3d27pt", 64, 3)])
    got = {}
    for s, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        got[s] = out.strip()
    (record,) = want.values()
    assert set(got.values()) == {record["plan_hash"]}, got


_HASHES_UNDER_SEED = """
import json, sys
from fractions import Fraction
from repro_torch.apps import get_case
from repro_torch.core import pairgraph
from repro_torch.core.race import race
keys = []
real = pairgraph.augment
def spy(vids, adj, colors):
    keys.extend(colors[v] for v in vids)
    return real(vids, adj, colors)
pairgraph.augment = spy
for name in ("j3d27pt", "rprj3", "psinv", "gaussian"):
    race(get_case(name, 10).program, reassociate=3)
objs = [("color", k) for k in keys] + ["", "aa_0_0", "\\u00e9t\\u00e9",
        "\\u0100\\u03a9", "\\U0001f600x", ("x", Fraction(-2, 3), None, 2**70)]
json.dump([[hash(o), pairgraph.seed0_hash(o)] for o in objs], sys.stdout)
"""


def test_seed0_hash_is_cpythons_under_seed_zero():
    """Under ``PYTHONHASHSEED=0`` the emulated hash equals ``hash()`` on
    the color vertices of four registry programs and on strings of every
    internal width."""
    proc = subprocess.run([sys.executable, "-c", _HASHES_UNDER_SEED],
                          env=_env("0"), capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    pairs = json.loads(proc.stdout)
    assert len(pairs) > 20
    assert all(h == e for h, e in pairs)


def test_color_vertex_is_its_tuple():
    k = ("+", 1, ("ref", "u", (1,)))
    v = pairgraph.ColorVertex(("color", k))
    assert v == ("color", k) and v[0] == "color" and isinstance(v, tuple)
    assert hash(v) == pairgraph.seed0_hash(("color", k))
    assert repr(v) == repr(("color", k))


def test_structure_records_match_in_process_off_the_list():
    """A pair outside :data:`SEED_DEPENDENT_PLANS` gives one record in this
    process and under seed 0, and the port's plan hash is the same."""
    req = ("plan", "gaussian", 12, 3)
    (want,) = reference_under_seed0([req]).values()
    assert ref_plan_record(*req[1:]) == want
    from repro_torch.apps import get_case

    res = repro_torch.race(get_case("gaussian", 12).program, reassociate=3)
    assert repro_torch.plan_hash(res.plan) == want["plan_hash"]
