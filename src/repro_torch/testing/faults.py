"""The programs behind the port's gradient faults F14 and F15, for the
tests and for ``chip_smoke.py``.

* F14: the autograd fallback (a refused adjoint build, or
  ``RACE_ADJOINT=autodiff``) raised when an output depends on no wanted
  input: a constant output, or one that reads unwanted inputs only;
* F15: a wanted input the program reads, whose adjoint terms all cancel,
  got ``None`` where the reference gives zeros.

Each function takes the IR module to build in (``repro_torch.core.ir``,
or any module with the same constructors: ``loopnest``, ``arr``,
``Scalar``, ``sin``, ``program``) and the grid extent ``n``, so one
function gives the same program in two packages' IRs."""

N = 8  # the tests' extent; chip_smoke.py runs three times it


def f14_strided(ir, n=N):
    """A strided read (``STRIDED_READ``), a constant output, and an output
    that reads ``B`` alone."""
    loops, (i, j) = ir.loopnest(("i", 0, n - 1), ("j", 0, n - 1))
    A, B = ir.arr("A"), ir.arr("B")
    s0 = ir.Scalar("s0")
    return ir.program(loops, [
        (ir.arr("out0")[i, j], A[2 * i + 1, j] - s0 + B[i + 2, j + 2]),
        (ir.arr("out1")[i, j], 0.3),
        (ir.arr("out2")[i, j], 0.3 - B[i + 1, j])])


def f14_mixed(ir, n=N, stride=2):
    """``A`` read at two strides of one level (``MIXED_LAYOUT``), and an
    output that reads ``B`` alone."""
    loops, (i, j) = ir.loopnest(("i", 0, n - 1), ("j", 0, n - 1))
    A, B = ir.arr("A"), ir.arr("B")
    return ir.program(loops, [
        (ir.arr("out0")[i, j], A[stride * i, j] * A[i + 1, j]),
        (ir.arr("out1")[i, j], ir.sin(B[i, j + 1]))])


def f14_unit(ir, n=N):
    """:func:`f14_mixed` at unit stride: its adjoint builds, so it reaches
    the fallback only under ``RACE_ADJOINT=autodiff``."""
    return f14_mixed(ir, n, stride=1)


def f15_sin(ir, n=N):
    """``B``'s terms cancel inside a ``sin``."""
    loops, (i, j) = ir.loopnest(("i", 0, n - 1), ("j", 0, n - 1))
    A, B = ir.arr("A"), ir.arr("B")
    return ir.program(loops, [
        (ir.arr("out0")[i, j], ir.sin(B[i, j] - B[i, j]) + A[i, j])])


def f15_scalar(ir, n=N):
    """The scalar ``s0``'s terms cancel."""
    loops, (i, j) = ir.loopnest(("i", 0, n - 1), ("j", 0, n - 1))
    A, B = ir.arr("A"), ir.arr("B")
    s0 = ir.Scalar("s0")
    return ir.program(loops, [
        (ir.arr("out0")[i, j], (s0 + A[i, j]) - s0 + B[i, j])])


PROGRAMS = {f.__name__: f for f in (f14_strided, f14_mixed, f14_unit,
                                    f15_sin, f15_scalar)}
#: the input of each F15 program whose terms all cancel
CANCELLED = {"f15_sin": "B", "f15_scalar": "s0"}
#: programs that reach the autograd fallback only when it is forced
FORCED = frozenset({"f14_unit"})
