"""The port's own spans in the traced window, for the per-layer metrics that
split the host's time by layer.

With ``torch.profiler`` recording, every ``obs`` span of the port opens a
profiler range named ``race.<span>`` (``repro_torch.obs``), with ``obs`` on
or off: ``entry`` and ``inputs`` (``RaceResult.run`` / ``run_batch``),
``lookup`` (choosing the executor), ``run`` / ``compile`` (the executor's
call), ``k1`` (K1's wrapper) and ``adjoint_backward`` (the adjoint layer's
backward), among others.  Here they are the host events of the trace whose
names start with ``race.`` (the harness's own ``racebench.`` ranges do not),
of either host category, that start inside ``racebench.window``, nested by
containment thread by thread.  A span's self time is its duration less its
direct ``race.`` children's on the same thread (the aten operations inside
it count as its own).  A reader returns None where the window holds no span
of the kind it reads.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

PREFIX = "race."


@dataclass
class Span:
    name: str  # without the prefix
    tid: object
    start: float  # µs
    end: float
    parent: "Span" = None  # the innermost enclosing span on its thread
    self_us: float = 0.0

    def within(self, name: str) -> bool:
        """Whether a span ``name`` encloses this one, at any depth."""
        p = self.parent
        while p is not None and p.name != name:
            p = p.parent
        return p is not None


def spans(trace) -> list:
    """The window's ``race.`` spans with their parents and self times, in
    the order they start; empty without a window."""
    win = trace.window()
    if win is None:
        return []
    out = sorted((Span(e["name"][len(PREFIX):], e.get("tid"), e["ts"],
                       e["ts"] + e["dur"], self_us=e["dur"])
                  for e in trace.host if e["name"].startswith(PREFIX)
                  and win[0] <= e["ts"] <= win[1]),
                 key=lambda s: (s.start, -s.end))
    open_ = defaultdict(list)  # thread -> the spans open at this start
    for s in out:
        stack = open_[s.tid]
        while stack and stack[-1].end <= s.start:
            stack.pop()
        if stack:
            s.parent = stack[-1]
            s.parent.self_us -= s.end - s.start
        stack.append(s)
    return out


def calls(trace, rng: str) -> int:
    """The harness's ranges ``racebench.<rng>`` that start in the window."""
    win = trace.window()
    return sum(win[0] <= lo <= win[1]
               for lo, _ in trace.ranges.get("racebench." + rng, ()))


def self_us(run, names, rng: str = "forward"):
    """Self µs of the spans named ``names`` per range ``racebench.<rng>``;
    None where the window holds none of them."""
    if run.trace is None:
        return None
    got = [s for s in spans(run.trace) if s.name in names]
    n = calls(run.trace, rng)
    if not got or not n:
        return None
    return sum(s.self_us for s in got) / n


def k1_calls(run):
    """``k1`` spans inside an ``adjoint_backward`` span, per
    ``adjoint_backward`` span (0 where none ran K1)."""
    if run.trace is None:
        return None
    all_ = spans(run.trace)
    backs = sum(s.name == "adjoint_backward" for s in all_)
    if not backs:
        return None
    return sum(s.name == "k1" and s.within("adjoint_backward")
               for s in all_) / backs


def _union(intervals) -> list:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        elif hi > lo:
            merged.append([lo, hi])
    return merged


def idle_in_program_pct(run):
    """Percent of the traced window in which the card ran nothing while
    some thread was inside a ``race.`` span; None without such a span or
    without device activity."""
    if run.trace is None or not run.trace.device:
        return None
    win = run.trace.window()
    inside = _union((max(s.start, win[0]), min(s.end, win[1]))
                    for s in spans(run.trace))
    if not inside:
        return None
    busy = run.trace.busy()
    covered, i = 0.0, 0
    for lo, hi in inside:
        while i < len(busy) and busy[i][1] <= lo:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < hi:
            covered += min(hi, busy[j][1]) - max(lo, busy[j][0])
            j += 1
    idle = sum(hi - lo for lo, hi in inside) - covered
    return 100.0 * idle / (win[1] - win[0])
