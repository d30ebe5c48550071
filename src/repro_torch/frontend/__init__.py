"""``repro_torch.frontend`` — trace plain Python/NumPy loop nests into RACE
IR.

Own copy of ``repro/frontend/__init__.py`` (the port imports nothing of
``repro``).  The capture entry path into the pipeline: ordinary functions
written as nested ``for`` loops over NumPy-style arrays become
:class:`repro_torch.core.ir.Program` objects, flow through the hash-based
detector, and execute on the port's backend layer (the torch evaluator or
the Hopper kernel).

    capture(fn, shapes)      -> Program          (AST capture)
    race_kernel / RaceKernel -> decorator with .trace()/.run()
    CaptureError             -> structured rejection (FrontendDiagnostic)
"""
from .capture import KNOWN_CALLS, capture
from .diagnostics import (ALL_CODES, CaptureError, D_CONTROL_FLOW,
                          D_IMPERFECT_NEST, D_LHS_FORM, D_LOOP_FORM,
                          D_LOOPVAR_VALUE, D_NO_LOOP, D_NON_AFFINE,
                          D_NON_INT_STRIDE, D_RANK_MISMATCH, D_UNKNOWN_CALL,
                          D_UNKNOWN_NAME, D_UNSUPPORTED_EXPR,
                          D_UNSUPPORTED_STMT, FrontendDiagnostic)
from .runtime import RaceKernel, race_kernel

__all__ = [
    "capture", "race_kernel", "RaceKernel", "CaptureError",
    "FrontendDiagnostic", "KNOWN_CALLS", "ALL_CODES",
    "D_NON_AFFINE", "D_NON_INT_STRIDE", "D_RANK_MISMATCH",
    "D_IMPERFECT_NEST", "D_CONTROL_FLOW", "D_LOOP_FORM", "D_LHS_FORM",
    "D_LOOPVAR_VALUE", "D_UNKNOWN_CALL", "D_UNKNOWN_NAME",
    "D_UNSUPPORTED_STMT", "D_UNSUPPORTED_EXPR", "D_NO_LOOP",
]
