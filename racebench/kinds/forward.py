"""Forward calls: one call is the program's outputs for one input set
(``RaceResult.run``, or ``run_batch`` where the traffic has a batch axis),
inside the range ``racebench.forward``.  Its answer is the outputs, judged
against the plain reference's."""
import time

import verdict

#: the functions of ``work/<program>.py`` whose bounds the metrics read
WORK = ("forward",)


def call(run, env: dict, rng):
    """``(outputs, host seconds inside the call)``."""
    with rng("racebench.forward"):
        t = time.perf_counter()
        out = run.forward(env)
        return out, time.perf_counter() - t


def reference(ref, program, env: dict, dtype):
    return verdict.reference_outputs(ref, program, env, dtype)


def gaps(answer, want, program) -> dict:
    return {"max_rel_err": verdict.output_gap(answer, want)}
