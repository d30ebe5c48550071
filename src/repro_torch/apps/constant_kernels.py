"""Programs whose right-hand sides hold constant subexpressions.

A constant subtree (``sin(0.3)``, ``exp(0.1)``, a right-hand side of no
array) is evaluated at float64 by the reference's ``"xla"`` under x64 and
meets the arrays as a weak scalar.  These programs hold the port's
evaluators to that, in float64, against the reference and against K1:

* ``const``: ``o[i] = 0.1``, a statement that reads no array (K1 refuses
  it: ``no-base-array``);
* ``sin``: ``o[i] = sin(0.3) * u[i]``;
* ``exp_pair``: ``o[i] = exp(0.1) * u[i] + exp(0.1) * u[i + 1]``, whose
  plan holds ``exp(0.1)`` as a scalar aux;
* ``log_neg``: ``o[i] = log(-1.0) * u[i]``, ``nan`` in both packages;

and :func:`twin`, a plain-Python loop for the capture frontend with
``math.sqrt(2.0)`` and ``math.exp(0.1)`` coefficients.

:func:`programs` builds them in the IR module it is given (the port's by
default; the tests pass the reference's too, whose builders are the same).
"""
from __future__ import annotations

import math

#: programs :func:`programs` builds, in order
NAMES = ("const", "sin", "exp_pair", "log_neg")


def programs(ir=None, n: int = 30) -> dict:
    """``{name: Program}`` over ``i in [1, n]`` (``u`` has ``n + 2``
    elements, ``o`` ``n + 1``)."""
    if ir is None:
        from ..core import ir
    loops, (i,) = ir.loopnest(("i", 1, n))
    u, o = ir.arr("u"), ir.arr("o")
    return {
        "const": ir.program(loops, [(o[i], ir.Const(0.1))]),
        "sin": ir.program(loops, [(o[i], ir.sin(0.3) * u[i])]),
        "exp_pair": ir.program(loops, [
            (o[i], ir.exp(0.1) * u[i] + ir.exp(0.1) * u[i + 1])]),
        "log_neg": ir.program(loops, [(o[i], ir.call("log", -1.0) * u[i])]),
    }


def twin(u, o):
    """``o[i] = √2 u[i-1] + e^0.1 u[i] + √2 u[i] + e^0.1 u[i+1]``: its two
    halves are one shifted pair, so the plan holds the pair as an aux."""
    n = u.shape[0]
    for i in range(1, n - 1):
        o[i] = (math.sqrt(2.0) * u[i - 1] + math.exp(0.1) * u[i]
                + math.sqrt(2.0) * u[i] + math.exp(0.1) * u[i + 1])
