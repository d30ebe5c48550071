"""95th percentile, over all of the window's calls, of one waited
`run_batch` call's latency: from the call to its result synchronised, on
the host's clock."""
from readings import latency_p95_ms


def read(run):
    return latency_p95_ms(run)
