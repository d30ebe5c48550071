"""K1 calls a backward makes: profiler ranges `race.k1` nested in a
`race.adjoint_backward` (the adjoint layer's backward), per
`race.adjoint_backward` in the traced window; 0 where it ran no K1."""
from progspans import k1_calls


def read(run):
    return k1_calls(run)
