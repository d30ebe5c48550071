"""Host microseconds a `run_batch` call spends in K1's wrapper
(`LoweredStencil`: checks, the scalars' stack, the outputs, the pointers,
the launch and the cast): the self time of the span `k1`, as profiler
range `race.k1` in the traced window, per call."""
from progspans import self_us


def read(run):
    return self_us(run, ("k1",))
