"""Points of the iteration space computed a second by `run` calls
dispatched ahead (every output of a point counts once), over all of the
window's calls and time, the card synchronised at its end."""
from readings import rate_gpts


def read(run):
    return rate_gpts(run)
