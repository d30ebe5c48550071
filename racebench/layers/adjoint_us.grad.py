"""Host microseconds a backward spends in the adjoint layer's own code
(`adjoint.backward`: `adjoint_runs`, the adjoint environments,
`finalize_adjoint`, `complete_gradients`): the self time of the span
`adjoint_backward`, as profiler range `race.adjoint_backward` on any
thread in the traced window, per `torch.autograd.grad`."""
from progspans import self_us


def read(run):
    return self_us(run, ("adjoint_backward",), "backward")
