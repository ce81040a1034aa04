"""Simplified verb-named API (reference include/slate/simplified_api.hh):
multiply → gemm, chol_factor → potrf, chol_solve → posv."""

from __future__ import annotations

from .errors import raise_if_info, slate_error_if
from .linalg.potrf import posv, potrf, potrs
from .matrix import HermitianMatrix, TriangularMatrix
from .ops.blas import gemm


def multiply(alpha, A, B, beta, C, opts=None):
    """C = alpha·A·B + beta·C for general A and B (hemm/symm are not
    ported yet, so a Hermitian or triangular operand raises)."""
    slate_error_if(
        isinstance(A, (HermitianMatrix, TriangularMatrix))
        or isinstance(B, (HermitianMatrix, TriangularMatrix)),
        "multiply: only general matrices are ported (no hemm/symm/trmm)")
    return gemm(alpha, A, B, beta, C, opts)


def chol_factor(A, opts=None):
    return potrf(A, opts)


def chol_solve(A, B, opts=None):
    X, L, info = posv(A, B, opts)
    raise_if_info(info, "potrf")
    return X


def chol_solve_using_factor(L, B, opts=None):
    return potrs(L, B, opts)
