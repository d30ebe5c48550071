"""Percent of its frozen bound (work/, peaks.py) at which one forward call
ran in a cell that reports `batch_p95_ms`: the bound over the device time of
everything launched inside the call, whatever its name, over the traced
calls."""
from readings import roofline_pct


def read(run):
    return roofline_pct(run, "forward", "forward")
