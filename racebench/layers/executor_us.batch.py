"""Host microseconds a `run_batch` call spends in the executor: the self
time of the spans `lookup` (the executor's key and cache lookup), `run`
and `compile` (`CompiledRace._run`), as profiler ranges `race.<span>` in
the traced window, per call."""
from progspans import self_us


def read(run):
    return self_us(run, ("lookup", "run", "compile"))
