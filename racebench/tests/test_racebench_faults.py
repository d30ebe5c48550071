"""``correct`` comes out false when the timed path is broken underneath.

Each test drives a whole run of a cell on the CPU at a tiny extent (past
the harness's look for a card), with one fault planted in the port below
the harness: a call that hands back a stale answer (its state unchanged), an
answer altered where it is produced, half of a batch left out, a stale or
altered gradient.  The cells run on one card, so no exchange between cards
can be left out.  A sound run of each cell is ``correct``
(``test_racebench_harness.py``).
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parents[1]
for _p in (HERE.parent / "src", HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import benchspec  # noqa: E402
import drive  # noqa: E402
from repro_torch.core import adjoint, executor  # noqa: E402

BENCH = benchspec.load()


def run_small(name, seed=2 ** 31 + 3):
    cell = benchspec.cell(BENCH, name)
    tr = {**cell.traffic, "extent": 8 + 2 * cell.program().HALO}
    if tr["batch"]:
        tr["batch"] = 4
    cell.traffic = tr
    return drive.measure(cell, seed, 0.3, False, "cpu")


def _stale_calls(monkeypatch):
    """Every call after the first hands back the first call's outputs."""
    orig = executor.CompiledRace._call
    first = {}

    def stale(self, env, batched, summed):
        out = orig(self, env, batched, summed)
        if summed:
            return out
        return first.setdefault((id(self), batched), out)

    monkeypatch.setattr(executor.CompiledRace, "_call", stale)


def _altered_answers(monkeypatch):
    """One point of the first output is off by one where it is produced."""
    orig = executor.CompiledRace._call

    def altered(self, env, batched, summed):
        out = orig(self, env, batched, summed)
        if summed:
            return out
        name = next(iter(out))
        t = out[name].clone()
        t.view(-1)[t.numel() // 2] += 1.0
        return {**out, name: t}

    monkeypatch.setattr(executor.CompiledRace, "_call", altered)


def _half_batch(monkeypatch):
    """A batched call computes its first half; the second half repeats it."""
    orig = executor.CompiledRace._call

    def half(self, env, batched, summed):
        out = orig(self, env, batched, summed)
        if not batched or summed:
            return out
        cut = {}
        for k, t in out.items():
            t = t.clone()
            h = t.shape[0] // 2
            t[h:2 * h] = t[:h]
            cut[k] = t
        return cut

    monkeypatch.setattr(executor.CompiledRace, "_call", half)


def _stale_gradients(monkeypatch):
    orig = adjoint.backward
    first = []

    def stale(*a, **kw):
        got = orig(*a, **kw)
        if not first:
            first.append(got)
        return first[0]

    monkeypatch.setattr(adjoint, "backward", stale)


def _altered_gradient(monkeypatch):
    """One scalar's gradient comes back doubled."""
    orig = adjoint.backward

    def altered(*a, **kw):
        got = dict(orig(*a, **kw))
        k = sorted(k for k, v in got.items()
                   if v is not None and v.dim() == 0)[0]
        got[k] = got[k] * 2
        return got

    monkeypatch.setattr(adjoint, "backward", altered)


FAULTS = [
    ("j3d27pt.sweep512", _stale_calls),
    ("j3d27pt.sweep512", _altered_answers),
    ("psinv.sweep514.f64", _stale_calls),
    ("psinv.sweep514.f64", _altered_answers),
    ("j3d27pt.batch64x256", _stale_calls),
    ("j3d27pt.batch64x256", _altered_answers),
    ("j3d27pt.batch64x256", _half_batch),
    ("j3d27pt.grad512", _altered_answers),
    ("j3d27pt.grad512", _stale_gradients),
    ("j3d27pt.grad512", _altered_gradient),
    ("j3d27pt.sweep512.bf16", _stale_calls),
    ("j3d27pt.sweep512.bf16", _altered_answers),
    ("poisson.sweep512", _stale_calls),
    ("poisson.sweep512", _altered_answers),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run_small(name)
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
