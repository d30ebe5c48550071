"""Own copy of ``repro/frontend/affine.py`` for the PyTorch port, which
imports nothing of ``repro``; ``tests/test_torch_frontend.py`` holds the
two against drift.

Affine-subscript recognition over Python AST (paper Algorithm 1 scope).

A subscript expression is admissible when it is an affine form ``a*i_s + b``
of *one* loop variable with integer coefficient ``a`` and integer offset
``b`` (negative and strided forms included), or a constant (then ``s == 0``
and the constant lives in ``b``).  Everything that is not a loop variable is
folded through compile-time constant evaluation against the capture
environment, so ``u[2*i + off]`` with ``off = 1`` bound earlier captures as
``Sub(2, s, 1)``.
"""
from __future__ import annotations

import ast
import numbers
from fractions import Fraction
from typing import Mapping

from ..core.ir import Sub

from .diagnostics import D_NON_AFFINE, D_NON_INT_STRIDE


class Reject(Exception):
    """Internal signal: construct outside the capturable scope.

    Carries the diagnostic code, human message, and the offending AST node;
    the capturer attaches source coordinates and re-raises as CaptureError.
    """

    def __init__(self, code: str, message: str, node: ast.AST):
        self.code, self.message, self.node = code, message, node
        super().__init__(message)


_SAFE_BUILTINS = {"len": len, "min": min, "max": max, "abs": abs, "int": int}


def const_eval(node: ast.AST, env: Mapping):
    """Evaluate ``node`` as a compile-time constant against ``env``.

    Returns the value or raises ``Reject(D_NON_AFFINE, ...)``; callers that
    want a different code catch and re-code.  ``env`` holds the function's
    globals/closure, capture consts, and array shape stubs.
    """
    expr = ast.Expression(body=node)
    ast.fix_missing_locations(expr)
    try:
        return eval(  # noqa: S307 - capture-time constant folding
            compile(expr, "<race-capture>", "eval"),
            {"__builtins__": _SAFE_BUILTINS}, dict(env))
    except Exception as e:  # noqa: BLE001
        raise Reject(
            D_NON_AFFINE,
            f"cannot evaluate as a capture-time constant: {e}", node) from e


def _as_fraction(value, node: ast.AST) -> Fraction:
    if isinstance(value, bool) or not isinstance(
            value, (numbers.Real, Fraction)):
        raise Reject(D_NON_AFFINE,
                     f"subscript term has non-numeric value {value!r}", node)
    if isinstance(value, numbers.Integral):
        return Fraction(int(value))  # np.int32/64 don't feed Fraction directly
    if isinstance(value, Fraction):
        return value
    return Fraction(float(value))


def parse_affine(node: ast.AST, loop_levels: Mapping[str, int], env: Mapping):
    """Decompose ``node`` into ``(coeffs {var: Fraction}, offset Fraction)``.

    Structure-directed over +, -, unary -, and * / / with a constant side;
    any subtree free of loop variables is constant-folded via ``env``.
    """
    if isinstance(node, ast.Name) and node.id in loop_levels:
        return {node.id: Fraction(1)}, Fraction(0)
    if isinstance(node, ast.Constant):
        return {}, _as_fraction(node.value, node)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        c, b = parse_affine(node.operand, loop_levels, env)
        return {v: -k for v, k in c.items()}, -b
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return parse_affine(node.operand, loop_levels, env)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)):
        cl, bl = parse_affine(node.left, loop_levels, env)
        cr, br = parse_affine(node.right, loop_levels, env)
        if isinstance(node.op, ast.Sub):
            cr, br = {v: -k for v, k in cr.items()}, -br
        merged = dict(cl)
        for v, k in cr.items():
            merged[v] = merged.get(v, Fraction(0)) + k
        return merged, bl + br
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        cl, bl = parse_affine(node.left, loop_levels, env)
        cr, br = parse_affine(node.right, loop_levels, env)
        if cl and cr:
            raise Reject(D_NON_AFFINE,
                         "product of two loop-variable terms", node)
        if cl:  # affine * constant
            aff_c, aff_b, scale = cl, bl, br
        else:  # constant * affine (or constant * constant)
            aff_c, aff_b, scale = cr, br, bl
        return {v: k * scale for v, k in aff_c.items()}, aff_b * scale
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        c, b = parse_affine(node.left, loop_levels, env)
        cd, bd = parse_affine(node.right, loop_levels, env)
        if cd:
            raise Reject(D_NON_AFFINE, "division by a loop variable", node)
        if bd == 0:
            raise Reject(D_NON_AFFINE, "division by zero in subscript", node)
        return {v: k / bd for v, k in c.items()}, b / bd
    # no loop variable may hide below any other construct: constant-fold it
    if any(isinstance(n, ast.Name) and n.id in loop_levels
           for n in ast.walk(node)):
        raise Reject(
            D_NON_AFFINE,
            "subscript uses a loop variable outside an affine a*i+b form",
            node)
    return {}, _as_fraction(const_eval(node, env), node)


def affine_to_sub(node: ast.AST, loop_levels: Mapping[str, int],
                  env: Mapping) -> Sub:
    """Parse one subscript dimension into a
    :class:`repro_torch.core.ir.Sub`."""
    coeffs, offset = parse_affine(node, loop_levels, env)
    used = [(v, k) for v, k in coeffs.items() if k != 0]
    if len(used) > 1:
        names = ", ".join(sorted(v for v, _ in used))
        raise Reject(
            D_NON_AFFINE,
            f"subscript couples loop variables {names}; the paper's form is "
            f"a*i+b over a single loop variable per dimension", node)
    if offset.denominator != 1:
        raise Reject(D_NON_INT_STRIDE,
                     f"fractional subscript offset {offset}", node)
    if not used:
        return Sub(0, 0, offset)
    var, coef = used[0]
    if coef.denominator != 1:
        raise Reject(
            D_NON_INT_STRIDE,
            f"loop variable {var} has non-integer stride {coef}", node)
    return Sub(int(coef), loop_levels[var], offset)
