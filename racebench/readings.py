"""The arithmetic the metric readers share.  Which cells report a metric is
``BENCHMARK.json``'s to say; a reader returns None only where the run holds
nothing to read (an untraced run has no trace, a trace without device
activity has no device time), and the harness then fails the run."""
import statistics

#: host spans that make up ``build_ms``
BUILD_SPANS = ("detect", "contract", "lower", "adjoint_build")


def p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def span_total_ms(spans: list, names=BUILD_SPANS) -> float:
    """Milliseconds in the spans named ``names`` that no other of them
    encloses (an adjoint build runs its own detection inside it)."""
    total = 0.0
    for s in spans:
        parts = s["path"].split("/")
        if parts[-1] in names and not any(p in names for p in parts[:-1]):
            total += s["dur_us"] / 1e3
    return total


def rate_gpts(run):
    """Points a second over the whole window, the card synchronised at its
    end."""
    return run.points * run.timed.calls / run.timed.elapsed / 1e9


def latency_p95_ms(run):
    """The 95th percentile of every waited call's latency."""
    return p95(run.timed.latency) * 1e3 if run.timed.latency else None


def build_ms(run):
    return span_total_ms(run.spans) if run.spans else None


def host_us(run):
    """Host microseconds inside one call (a step: its forward call and its
    ``autograd.grad``), over the untraced half of the traced run."""
    if not run.timed.calls:
        return None
    return run.timed.host_s / run.timed.calls * 1e6


def roofline_pct(run, rng, bound):
    """Percent of the frozen bound ``run.bound[bound]`` at which the ranges
    ``racebench.<rng>`` ran: the bound times the ranges over the device time
    of everything launched inside them."""
    if run.trace is None or bound not in run.bound:
        return None
    per = run.trace.per_range(rng)
    busy = sum(s for s, _ in per)
    if not busy:
        return None
    return 100.0 * run.bound[bound] * len(per) / busy


def launches(run, rng):
    """Kernels launched inside one range ``racebench.<rng>``, on average."""
    if run.trace is None:
        return None
    per = run.trace.per_range(rng)
    if not per or not any(k for _, k in per):
        return None
    return sum(k for _, k in per) / len(per)


def idle_pct(run):
    """Percent of the traced window in which the card ran nothing."""
    if run.trace is None:
        return None
    window = run.trace.window_s()
    if not window or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / window)
