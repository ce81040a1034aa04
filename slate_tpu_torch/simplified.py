"""Simplified verb-named API (reference include/slate/simplified_api.hh):
multiply → gemm/hemm/symm, triangular_multiply → trmm, triangular_solve
→ trsm, rank_k_update → herk/syrk, rank_2k_update → her2k/syr2k,
chol_factor → potrf, chol_solve → posv, lu_factor →
getrf, lu_solve → gesv, the inverse verbs → getri / potri, the
unpivoted LU verbs, indefinite_factor /
indefinite_solve → hetrf / hesv, least_squares_solve → gels, the QR/LQ
verbs, and eig_vals/eig → heev, svd_vals/svd → gesvd."""

from __future__ import annotations

from .errors import raise_if_info
from .linalg.eig import heev
from .linalg.geqrf import gelqf, gels, geqrf, unmlq, unmqr
from .linalg.getrf import (gesv, gesv_nopiv, getrf, getrf_nopiv, getrs,
                           getrs_nopiv)
from .linalg.hetrf import hesv, hetrf, hetrs
from .linalg.potrf import posv, potrf, potrs
from .linalg.svd import gesvd
from .linalg.trtri import getri, potri
from .matrix import HermitianMatrix, SymmetricMatrix
from .ops.blas import (gemm, hemm, her2k, herk, symm, syr2k, syrk, trmm,
                       trsm)
from .types import Op, Side


def multiply(alpha, A, B, beta, C, opts=None):
    """C = alpha·A·B + beta·C (simplified_api's gemm/hemm/symm dispatch,
    ``simplified.py:14-24``): a Hermitian or symmetric A goes to
    hemm/symm on the left, such a B to hemm/symm on the right, anything
    else to gemm."""
    if isinstance(A, HermitianMatrix):
        return hemm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(A, SymmetricMatrix):
        return symm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, HermitianMatrix):
        return hemm(Side.Right, alpha, B, A, beta, C, opts)
    if isinstance(B, SymmetricMatrix):
        return symm(Side.Right, alpha, B, A, beta, C, opts)
    return gemm(alpha, A, B, beta, C, opts)


def triangular_multiply(alpha, A, B, opts=None, side: Side = Side.Left):
    """B ← alpha·A·B (or alpha·B·A on the right), A triangular (trmm)."""
    return trmm(side, alpha, A, B, opts)


def triangular_solve(alpha, A, B, opts=None, side: Side = Side.Left):
    """Solve A·X = alpha·B (or X·A on the right), A triangular (trsm)."""
    return trsm(side, alpha, A, B, opts)


def rank_k_update(alpha, A, beta, C, opts=None):
    """C ← alpha·A·Aᴴ + beta·C: herk on a Hermitian C, syrk otherwise."""
    if isinstance(C, HermitianMatrix):
        return herk(alpha, A, beta, C, opts)
    return syrk(alpha, A, beta, C, opts)


def rank_2k_update(alpha, A, B, beta, C, opts=None):
    """C ← alpha·A·Bᴴ + conj(alpha)·B·Aᴴ + beta·C: her2k on a Hermitian
    C, syr2k otherwise."""
    if isinstance(C, HermitianMatrix):
        return her2k(alpha, A, B, beta, C, opts)
    return syr2k(alpha, A, B, beta, C, opts)


def chol_factor(A, opts=None):
    return potrf(A, opts)


def chol_solve(A, B, opts=None):
    X, L, info = posv(A, B, opts)
    raise_if_info(info, "potrf")
    return X


def chol_solve_using_factor(L, B, opts=None):
    return potrs(L, B, opts)


def chol_inverse_using_factor(L, opts=None):
    """A⁻¹ from chol_factor's output (potri)."""
    return potri(L, opts)


def lu_factor(A, opts=None):
    return getrf(A, opts)


def lu_solve(A, B, opts=None):
    X, LU, piv, info = gesv(A, B, opts)
    raise_if_info(info, "getrf")
    return X


def lu_solve_using_factor(LU, piv, B, opts=None):
    return getrs(LU, piv, B, Op.NoTrans, opts)


def lu_inverse_using_factor(LU, piv, opts=None):
    """A⁻¹ from lu_factor's output (getri)."""
    return getri(LU, piv, opts)


def lu_inverse_using_factor_out_of_place(LU, piv, opts=None):
    """Out-of-place inverse (reference getriOOP): the same algorithm;
    the port's drivers never update their inputs, so it is the in-place
    verb on a new result."""
    return getri(LU, piv, opts)


def lu_factor_nopiv(A, opts=None):
    return getrf_nopiv(A, opts)


def lu_solve_nopiv(A, B, opts=None):
    X, LU, info = gesv_nopiv(A, B, opts)
    raise_if_info(info, "getrf")
    return X


def lu_solve_using_factor_nopiv(LU, B, opts=None):
    return getrs_nopiv(LU, B, opts)


def indefinite_factor(A, opts=None):
    return hetrf(A, opts)


def indefinite_solve(A, B, opts=None):
    X, factors, info = hesv(A, B, opts)
    raise_if_info(info, "hetrf")
    return X


def indefinite_solve_using_factor(factors, B, opts=None):
    return hetrs(factors, B, opts)


def least_squares_solve(A, BX, opts=None):
    return gels(A, BX, opts)


def qr_factor(A, opts=None):
    return geqrf(A, opts)


def lq_factor(A, opts=None):
    return gelqf(A, opts)


def qr_multiply_by_q(side, op, QR, T, C, opts=None):
    """C ← op(Q)·C or C·op(Q) from qr_factor's output (unmqr)."""
    return unmqr(side, op, QR, T, C, opts)


def lq_multiply_by_q(side, op, LQ, T, C, opts=None):
    """C ← op(Q)·C or C·op(Q) from lq_factor's output (unmlq)."""
    return unmlq(side, op, LQ, T, C, opts)


def eig_vals(A, opts=None):
    """Eigenvalues of a Hermitian (or real symmetric) matrix, ascending,
    in its real dtype (heev)."""
    lam, _ = heev(A, opts, want_vectors=False)
    return lam


def eig(A, opts=None):
    """``(lam, Z)`` of a Hermitian (or real symmetric) matrix, lam in its
    real dtype (heev)."""
    return heev(A, opts, want_vectors=True)


def svd_vals(A, opts=None):
    """Singular values, descending, in A's real dtype (gesvd)."""
    s, _, _ = gesvd(A, opts)
    return s


def svd(A, opts=None):
    """``(s, U, VT)``, VT = Vᴴ and s in A's real dtype (gesvd)."""
    return gesvd(A, opts, want_u=True, want_vt=True)
