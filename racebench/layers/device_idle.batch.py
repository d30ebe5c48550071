"""Percent of the traced window in which no kernel, copy or fill ran on the
card (the profiler's timeline), in a cell that reports `batch_p95_ms`."""
from readings import idle_pct


def read(run):
    return idle_pct(run)
