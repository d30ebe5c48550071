"""Own copy of ``repro/core/integration.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_entry.py`` holds the two
against drift.

RACE applied to the LM stack (DESIGN.md section 4).

The transformer's positional computation is a loop nest:

    for l in [0, L):           # layer loop
      for p in [0, S):         # positions
        for d in [0, Dh/2):    # rotary channel pairs
          c[l,p,d] = cos(pos[p] * invfreq[d])
          s[l,p,d] = sin(pos[p] * invfreq[d])

Expressed as RACE expression trees, every layer's cos/sin call has the same
eri — the layer-loop index never appears in any operand, so exprDelta is
empty on that axis and the whole group collapses into ONE auxiliary array
aa[p, d]: the RoPE cache.  ``rope_hoisting_plan`` builds that nest, runs the
standard RACE pipeline, and returns the analysis.  The same analysis
certifies the VLM cross-attention K/V hoist: the vision embeddings are
layer-invariant, so the per-cross-layer K/V projections of a *shared* tower
would hoist identically (per-layer projections with distinct weights have
distinct rpi names, so RACE correctly finds nothing: the negative case).
"""
from __future__ import annotations

from dataclasses import dataclass

from .analysis import op_table
from .ir import arr, call, loopnest, program
from .race import RaceResult, race


@dataclass
class HoistReport:
    result: RaceResult
    sincos_per_iter_before: float
    sincos_per_iter_after: float

    @property
    def layer_invariant(self) -> bool:
        # hoisting succeeded iff per-(l,p,d) trig cost dropped by ~1/L
        return self.sincos_per_iter_after < 0.5 * self.sincos_per_iter_before


def rope_nest(n_layers: int, seq: int, half_dh: int):
    loops, (l, p, d) = loopnest(("l", 0, n_layers - 1), ("p", 0, seq - 1),
                                ("d", 0, half_dh - 1))
    ang = arr("angle")  # angle[p, d] = pos[p] * invfreq[d] (precomputed)
    ccache, scache = arr("c"), arr("s")
    return program(loops, [
        (ccache[l, p, d], call("cos", ang[p, d])),
        (scache[l, p, d], call("sin", ang[p, d])),
    ])


def rope_hoisting_plan(n_layers: int = 4, seq: int = 8,
                       half_dh: int = 4) -> HoistReport:
    prog = rope_nest(n_layers, seq, half_dh)
    res = race(prog)  # binary mode suffices: zero-shift CSE across the l loop
    before = op_table(prog)["sincos"]
    after = op_table(prog, res.plan)["sincos"]
    return HoistReport(res, before, after)
