"""Seconds from the harness's first statement to the first timed call:
imports, the card's start-up, RACE's build, drawing the inputs, and the
warm-up that builds (nvcc, in a fresh checkout) or loads every kernel."""


def read(run):
    return run.setup_s
