"""Host milliseconds of RACE's compiler in set-up: the port's `obs` spans
`detect`, `contract` (core/race.py), `lower` (core/executor.py) and
`adjoint_build` (core/adjoint.py), each where no other of them encloses
it."""
from readings import build_ms


def read(run):
    return build_ms(run)
