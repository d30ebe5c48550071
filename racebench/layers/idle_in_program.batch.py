"""Percent of the traced window in which no kernel, copy or fill ran on the
card while some thread was inside one of the port's spans (a profiler
range `race.<span>`), in a cell that reports `batch_p95_ms`: the part of
`device_idle.batch` the port's own host code accounts for."""
from progspans import idle_in_program_pct


def read(run):
    return idle_in_program_pct(run)
