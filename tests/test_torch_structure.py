"""The port's copies of the jax-free reference modules (IR, detection,
contraction, analysis, geometry, registry) give the reference's programs,
plans and probe verdicts: equal hashes, op reductions, aux counts and codes
across the registry at reassociate 0 and each case's default.  Where the
reference's plan follows PYTHONHASHSEED (ROADMAP F7), the port is held to
the reference's plan under seed 0, taken in a subprocess."""
import numpy as np
import pytest

from repro.apps.paper_kernels import CASES
from repro.apps.paper_kernels import get_case as ref_case
from repro.core import ir as ref_ir
from repro.core.executor import program_hash as ref_program_hash
from repro.core.race import race as ref_race
from repro.testing import build_env as ref_build_env

import repro_torch
from repro_torch.apps import get_case
from repro_torch.core import ir
from repro_torch.testing import SWEEP_SIZES, build_env
from test_torch_seed import (SEED_DEPENDENT_PLANS, ref_plan_record,
                             reference_under_seed0)

pytestmark = pytest.mark.port


def _level(name, which):
    return 0 if which == "r0" else ref_case(name, SWEEP_SIZES[name]).reassociate


@pytest.fixture(scope="module")
def seed0():
    """The reference's records, under PYTHONHASHSEED=0, of the pairs whose
    reference plan follows the seed (F7; the port's does not)."""
    return reference_under_seed0(sorted({
        ("plan", name, SWEEP_SIZES[name], _level(name, which))
        for name in CASES for which in ("r0", "default")
        if (name, _level(name, which)) in SEED_DEPENDENT_PLANS}))


@pytest.mark.parametrize("which", ["r0", "default"])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_structure_matches_reference(name, which, seed0):
    rc, pc = ref_case(name, SWEEP_SIZES[name]), get_case(name, SWEEP_SIZES[name])
    assert repro_torch.program_hash(pc.program) == ref_program_hash(rc.program)
    lvl = _level(name, which)
    assert pc.reassociate == rc.reassociate
    key = ("plan", name, SWEEP_SIZES[name], lvl)
    want = seed0.get(key) or ref_plan_record(*key[1:])
    port_res = repro_torch.race(pc.program, reassociate=lvl,
                                rewrite_div=pc.rewrite_div)
    assert repro_torch.plan_hash(port_res.plan) == want["plan_hash"]
    assert port_res.reduced_ops() == want["reduced_ops"]
    assert port_res.n_aux() == want["n_aux"]
    assert port_res.n_aux_materialized() == want["n_aux_materialized"]
    pcap = port_res.capability()
    assert pcap.eligible == want["eligible"]
    assert [r.code for r in pcap.reasons] == want["reasons"]
    assert [f.code for f in pcap.facts] == want["facts"]
    assert port_res.to_source() == want["to_source"]


@pytest.mark.parametrize("name", list(CASES))
def test_build_env_matches_reference(name):
    rc, pc = ref_case(name, SWEEP_SIZES[name]), get_case(name, SWEEP_SIZES[name])
    for dt in (np.float32, np.float64):
        want, got = ref_build_env(rc, dt, seed=3), build_env(pc, dt, seed=3)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k])


def _out_of_model(m):
    """Programs the probe refuses, built with either package's IR: an output
    that skips a level, and a zero-coefficient read."""
    loops, (i, j) = m.loopnest(("i", 1, 8), ("j", 1, 8))
    u, o = m.arr("u"), m.arr("o")
    skip = m.program(loops, [(o[i, 0], u[i, j - 1] + u[i, j + 1])])
    zero = m.program(loops, [(o[i, j], u[i, j] * u[i * 0 + 2, j])])
    return [skip, zero]


@pytest.mark.parametrize("k", [0, 1])
def test_refusal_codes_match_reference(k):
    ref_res = ref_race(_out_of_model(ref_ir)[k], reassociate=3)
    port_res = repro_torch.race(_out_of_model(ir)[k], reassociate=3)
    rcodes = [r.code for r in ref_res.capability().reasons]
    assert rcodes
    assert [r.code for r in port_res.capability().reasons] == rcodes
    assert port_res.select_backend("auto").backend == "torch"
