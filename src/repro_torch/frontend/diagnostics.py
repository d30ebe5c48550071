"""Own copy of ``repro/frontend/diagnostics.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_frontend.py`` holds the
two against drift.

Structured capture diagnostics.

The frontend mirrors the backend capability probe's contract
(``repro_torch.core.backend``): rejection is never silent.  Every input the
capturer cannot express in the paper's scope (Section 4.1 — perfect nest,
no internal control flow, affine subscripts ``a*i+b``) produces a
:class:`FrontendDiagnostic` with a stable machine-readable code and the
source line/column of the offending construct, wrapped in a
:class:`CaptureError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: machine-readable rejection codes (stable API for tests / tooling)
D_NON_AFFINE = "non-affine-subscript"
D_NON_INT_STRIDE = "non-integer-stride"
D_RANK_MISMATCH = "rank-mismatch"
D_IMPERFECT_NEST = "imperfect-nest"
D_CONTROL_FLOW = "control-flow"
D_LOOP_FORM = "loop-form"
D_LHS_FORM = "lhs-form"
D_LOOPVAR_VALUE = "loop-var-as-value"
D_UNKNOWN_CALL = "unknown-call"
D_UNKNOWN_NAME = "unknown-name"
D_UNSUPPORTED_STMT = "unsupported-statement"
D_UNSUPPORTED_EXPR = "unsupported-expression"
D_NO_LOOP = "no-loop-nest"

ALL_CODES = (
    D_NON_AFFINE, D_NON_INT_STRIDE, D_RANK_MISMATCH, D_IMPERFECT_NEST,
    D_CONTROL_FLOW, D_LOOP_FORM, D_LHS_FORM, D_LOOPVAR_VALUE,
    D_UNKNOWN_CALL, D_UNKNOWN_NAME, D_UNSUPPORTED_STMT, D_UNSUPPORTED_EXPR,
    D_NO_LOOP,
)


@dataclass(frozen=True)
class FrontendDiagnostic:
    """One structural obstacle to capturing a Python function as RACE IR."""

    code: str
    message: str
    line: int  # 1-based line in ``file`` (the function's source file)
    col: int  # 0-based column
    file: Optional[str] = None
    function: Optional[str] = None

    def __str__(self) -> str:
        where = f"{self.file or '<source>'}:{self.line}:{self.col}"
        fn = f" (in {self.function})" if self.function else ""
        return f"{where}: {self.code}: {self.message}{fn}"


class CaptureError(ValueError):
    """Raised when a function cannot be captured; carries the diagnostic."""

    def __init__(self, diagnostic: FrontendDiagnostic):
        self.diagnostic = diagnostic
        super().__init__(str(diagnostic))
