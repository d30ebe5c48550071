"""Points of the iteration space a second by waited `run_batch` calls (every
example's points), over all of the window's calls and time."""
from readings import rate_gpts


def read(run):
    return rate_gpts(run)
