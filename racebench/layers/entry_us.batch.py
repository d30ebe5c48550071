"""Host microseconds a `run_batch` call spends in the port's entry point:
the self time of its spans `entry` and `inputs` (`RaceResult.run_batch`:
`resolve_device`, `stack_envs`, `stacked_signature`), as profiler ranges
`race.entry` and `race.inputs` in the traced window, per call."""
from progspans import self_us


def read(run):
    return self_us(run, ("entry", "inputs"))
