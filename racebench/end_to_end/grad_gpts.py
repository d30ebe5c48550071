"""Points of the iteration space a second in forward-plus-backward steps,
over all of the window's steps and time, the card synchronised at its
end."""
from readings import rate_gpts


def read(run):
    return rate_gpts(run)
