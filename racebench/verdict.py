"""How ``correct`` is decided.

Once the window has closed, the timed path's sampled answers are held
against the plain reference (``reference/<program>.py``), run in float64
on the same inputs, which the harness drew and handed to both sides.  The
traffic's kind (``kinds/<kind>.py``) says what its answer is, how the
reference computes it (``reference``) and which numbers are compared
(``gaps``), each against its limit in ``limits/<cell>.json``:

- ``max_rel_err``: over every output, the largest ``|got - want|`` over the
  largest ``|want|``;
- ``grad_rel_err``: over every input's gradient, the largest
  ``|got - want|`` over a scale: an array's largest ``|want|``, a scalar's
  own ``|want|`` or the median of the scalars', whichever is larger (a
  scalar's gradient is a sum over every point that can come out near zero
  on a seed).

The control puts the reference, computed in the cell's ``control_dtype``
(``limits/<cell>.json``: the nearest precision below the cell's), in the
program's place; ``calibrate.py`` reads it.  torch does no arithmetic in
a 1-byte float such as ``float8_e4m3fn`` (the control of a bfloat16
cell), so there the reference runs under :class:`Rounding`: every
floating-point result of its operations (each input as it is read, each
intermediate, each output) is rounded through that dtype and carried in
float32.
"""
from __future__ import annotations

import math
import statistics

import torch
from torch.overrides import TorchFunctionMode

REFERENCE_DTYPE = torch.float64
#: the dtype that carries a 1-byte float's values through arithmetic
CARRIER = torch.float32


def _round(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype).to(CARRIER)
    if type(x) in (tuple, list):
        return type(x)(_round(v, dtype) for v in x)
    return x


class Rounding(TorchFunctionMode):
    """Inside it, every floating-point tensor that a torch function
    returns is rounded to ``dtype`` and handed on in :data:`CARRIER`: the
    arithmetic of a dtype torch only stores, operation by operation.
    Autograd's backward runs below torch functions, so it is not
    rounded."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _round(func(*args, **(kwargs or {})), self.dtype)


def computed_in(kind, ref, program, env: dict, dtype):
    """The reference's answer for one input set, computed in ``dtype``:
    directly where torch computes in it, under :class:`Rounding` where it
    is a 1-byte float."""
    if dtype.is_floating_point and dtype.itemsize == 1:
        with Rounding(dtype):
            return kind.reference(ref, program, env, CARRIER)
    return kind.reference(ref, program, env, dtype)


def _leaves(program, env: dict, dtype) -> tuple:
    arrays = {k: env[k].detach().to(dtype) for k in program.ARRAYS}
    scalars = {k: env[k].detach().to(dtype) for k in program.SCALARS}
    return arrays, scalars


def reference_outputs(ref, program, env: dict, dtype=REFERENCE_DTYPE):
    """The reference's outputs for one input set, computed in ``dtype``."""
    with torch.no_grad():
        return ref.forward(*_leaves(program, env, dtype))


def reference_gradients(ref, program, env: dict, dtype=REFERENCE_DTYPE):
    """``(outputs, gradients)`` of the reference for one input set, by
    plain autograd against ``env["cotangent"]``, computed in ``dtype``."""
    arrays, scalars = _leaves(program, env, dtype)
    leaves = {**arrays, **scalars}
    for v in leaves.values():
        v.requires_grad_()
    with torch.enable_grad():
        out = ref.forward(arrays, scalars)
        grads = torch.autograd.grad(
            [out[o] for o in program.OUTPUTS], list(leaves.values()),
            [env["cotangent"][o].detach().to(dtype) for o in program.OUTPUTS])
    return ({k: v.detach() for k, v in out.items()}, dict(zip(leaves, grads)))


def _gap(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    diff = float((got.detach().to(want.dtype) - want).abs().max())
    if not (math.isfinite(diff) and math.isfinite(scale)):
        return math.inf
    return diff / max(scale, 1e-300)


def output_gap(got: dict, want: dict) -> float:
    """``max_rel_err`` of one answer's outputs."""
    return max(_gap(got[k], w, float(w.abs().max())) for k, w in want.items())


def grad_gap(got: dict, want: dict, scalars: tuple) -> float:
    """``grad_rel_err`` of one answer's gradients."""
    mid = statistics.median(float(want[s].abs().max()) for s in scalars) \
        if scalars else 0.0
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max())
        if k in scalars:
            scale = max(scale, mid)
        worst = max(worst, _gap(got[k], w, scale))
    return worst


def judge(cell, program, kind, inputs: list, answers: list) -> tuple:
    """``({number: (worst value, limit)}, answers over a limit)`` of the
    sampled ``(pool index, answer)`` pairs; the reference runs once per
    input set."""
    ref = cell.reference()
    limits = cell.limits
    worst = {}
    failed = 0
    for p in sorted({p for p, _ in answers}):
        want = kind.reference(ref, program, inputs[p], REFERENCE_DTYPE)
        for q, answer in answers:
            if q != p:
                continue
            g = kind.gaps(answer, want, program)
            failed += any(v > limits[k] for k, v in g.items())
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
        del want
    return {k: (v, limits[k]) for k, v in worst.items()}, failed


def control(cell, program, kind, inputs: list) -> dict:
    """The control's numbers: the reference in the cell's
    ``control_dtype``, held against the float64 reference, worst over the
    input sets."""
    ref = cell.reference()
    low = getattr(torch, cell.control_dtype)
    worst = {}
    for env in inputs:
        want = kind.reference(ref, program, env, REFERENCE_DTYPE)
        got = computed_in(kind, ref, program, env, low)
        for k, v in kind.gaps(got, want, program).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want, got
    return worst
