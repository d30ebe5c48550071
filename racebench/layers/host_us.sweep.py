"""Host microseconds inside one call (its enqueue through the entry point
and the executor) in a cell that reports `sweep_gpts`, over the untraced half
of the traced run."""
from readings import host_us


def read(run):
    return host_us(run)
