"""Percent of its frozen bound (work/, peaks.py) at which one backward ran:
the bound over the device time of everything launched inside
`torch.autograd.grad`, over the traced steps."""
from readings import roofline_pct


def read(run):
    return roofline_pct(run, "backward", "backward")
