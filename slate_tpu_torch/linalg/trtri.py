"""Inverses: trtri (triangular), trtrm, potri (SPD) and getri (general)
(reference src/trtri.cc, src/trtrm.cc, src/potri.cc, src/getri.cc;
counterpart of ``slate_tpu/linalg/trtri.py``).

trtri solves against the identity (X = A⁻¹ ⇔ A·X = I) with the port's
trsm, so a lower factor goes through the left-solve kernel K3 on a
right-hand side as wide as the matrix. getri follows the reference's
algorithm: U⁻¹ by trtri, then X·L = U⁻¹ (a right unit-lower solve) and
the column swaps in reverse order (A⁻¹ = U⁻¹·L⁻¹·P), 4n³/3 flops. potri
forms L⁻ᴴ·L⁻¹ with one product, the reference's trtrm step.

On a p×q grid each is the same composition of p×q routines, as in the
JAX package: the identity by ``set_matrix``, ``trsm`` on either side
(the SPMD block substitutions), the product by SUMMA ``gemm`` and
getri's column swaps as row swaps of the block-cyclic transpose of X
(``_apply_pivots_matrix``, the rows fetched from their owners).
"""

from __future__ import annotations

from ..matrix import (HermitianMatrix, Matrix, TriangularMatrix,
                      conj_transpose, transpose)
from ..ops.blas import _extract_triangle, gemm, trsm
from ..ops.elementwise import set_matrix
from ..types import Diag, Side, Uplo


def _identity_like(A) -> Matrix:
    I = Matrix.zeros(A.n, A.n, A.nb, A.grid, dtype=A.dtype)
    return set_matrix(0.0, 1.0, I)


def trtri(A: TriangularMatrix, opts=None) -> TriangularMatrix:
    """A⁻¹ of a triangular matrix (reference src/trtri.cc)."""
    X = trsm(Side.Left, 1.0, A, _identity_like(A), opts)
    return TriangularMatrix(data=X.data, m=A.m, n=A.n, nb=A.nb,
                            grid=A.grid, uplo=A.uplo, diag=A.diag)


def trtrm(A: TriangularMatrix, opts=None) -> HermitianMatrix:
    """Lᴴ·L for lower A = L, U·Uᴴ for upper A = U (reference
    src/trtrm.cc, LAPACK lauum; the second half of potri), both triangles
    stored. The JAX package forms Aᴴ·A for either, which for an upper
    factor is not the inverse potri needs."""
    At = _extract_triangle(A)
    C = Matrix.zeros(A.n, A.n, A.nb, A.grid, dtype=A.dtype)
    if A.uplo == Uplo.Upper:
        C = gemm(1.0, At, conj_transpose(At), 0.0, C)
    else:
        C = gemm(1.0, conj_transpose(At), At, 0.0, C)
    return HermitianMatrix(data=C.data, m=A.n, n=A.n, nb=A.nb,
                           grid=A.grid, uplo=A.uplo)


def potri(L: TriangularMatrix, opts=None) -> HermitianMatrix:
    """A⁻¹ from the Cholesky factor: A⁻¹ = L⁻ᴴ·L⁻¹, or U⁻¹·U⁻ᴴ for an
    upper factor (src/potri.cc)."""
    return trtrm(trtri(L, opts), opts)


def getri(LU: Matrix, piv, opts=None) -> Matrix:
    """A⁻¹ from getrf factors (reference src/getri.cc): U⁻¹ by trtri,
    then X·L = U⁻¹ and the column permutation (A⁻¹ = U⁻¹·L⁻¹·P)."""
    from .getrf import _apply_pivots_matrix
    n = LU.n
    U = TriangularMatrix(data=LU.data, m=n, n=n, nb=LU.nb, grid=LU.grid,
                         uplo=Uplo.Upper, diag=Diag.NonUnit)
    Uinv = trtri(U, opts)
    L = TriangularMatrix(data=LU.data, m=n, n=n, nb=LU.nb, grid=LU.grid,
                         uplo=Uplo.Lower, diag=Diag.Unit)
    X = trsm(Side.Right, 1.0, L, Matrix(data=Uinv.data, m=n, n=n,
                                        nb=LU.nb, grid=LU.grid), opts)
    # A⁻¹ = X·P: the swaps in reverse order on the columns, i.e. on the
    # rows of Xᵀ (LAPACK dgetri's trailing column sweep)
    Xp = _apply_pivots_matrix(transpose(X).materialize(), piv, forward=False)
    return transpose(Xp).materialize()
