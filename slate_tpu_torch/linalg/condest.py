"""Condition-number estimates: gecondest / pocondest / trcondest
(reference src/gecondest.cc:128-152, src/trcondest.cc; counterpart of
``slate_tpu/linalg/condest.py``).

LAPACK ?gecon semantics: rcond = 1 / (‖A‖₁ · est(‖A⁻¹‖₁)). The
Hager/Higham estimator runs on the host in f64 numpy and drives the
port's solves on [n, 1] matrices, as the reference's norm1est loop sits
above its solvers. Each vector is laid out on the factor's grid and tile
size, so on a p×q grid the solves are the p×q ``getrs``/``potrs``/
``trsm``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..matrix import Matrix, conj_transpose, transpose
from ..ops.blas import trsm
from ..ops.norms import norm
from ..types import Norm, Op, Side


def _onenormest(solve, solve_t, n: int, itmax: int = 5,
                cplx: bool = False) -> float:
    """Hager/Higham 1-norm estimate of an operator given x ↦ op⁻¹x and
    x ↦ op⁻ᴴx (LAPACK xLACN2; the complex variant takes ξ = y/|y| in
    place of sign(y))."""
    dt = np.complex128 if cplx else np.float64
    x = np.full(n, 1.0 / n, dt)
    est = 0.0
    for _ in range(itmax):
        y = solve(x)                     # y = A⁻¹ x
        est_new = float(np.abs(y).sum())
        if cplx:
            ay = np.abs(y)
            xi = np.where(ay == 0, 1.0, y / np.where(ay == 0, 1.0, ay))
        else:
            xi = np.sign(y)
            xi[xi == 0] = 1.0
        z = solve_t(xi)                  # z = A⁻ᴴ ξ
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= np.abs(z @ x) or est_new <= est:
            est = max(est, est_new)
            break
        est = est_new
        x = np.zeros(n, dt)
        x[j] = 1.0
    return est


def _vec_solve(fn, A, v: np.ndarray) -> np.ndarray:
    """``fn`` applied to the vector ``v`` as an [n, 1] matrix on A's
    grid, at A's dtype; the result back in f64 (c128) numpy."""
    V = Matrix.from_dense(torch.from_numpy(v).to(A.dtype)[:, None],
                          nb=A.nb, grid=A.grid)
    out = fn(V).to_dense().cpu().numpy().reshape(-1)
    if np.iscomplexobj(out):
        return out.astype(np.complex128)
    return out.astype(np.float64)


def _rcond(Anorm: float, inv_est: float) -> float:
    if Anorm == 0 or inv_est == 0:
        return 0.0
    return 1.0 / (Anorm * inv_est)


def gecondest(norm_kind: Norm, LU: Matrix, piv, Anorm: float, opts=None):
    """rcond estimate from getrf factors (reference src/gecondest.cc)."""
    from .getrf import getrs
    cplx = LU.dtype.is_complex
    opT = Op.ConjTrans if cplx else Op.Trans
    inv_est = _onenormest(
        lambda v: _vec_solve(lambda V: getrs(LU, piv, V, Op.NoTrans, opts),
                             LU, v),
        lambda v: _vec_solve(lambda V: getrs(LU, piv, V, opT, opts), LU, v),
        LU.n, cplx=cplx)
    return _rcond(Anorm, inv_est)


def pocondest(norm_kind: Norm, L, Anorm: float, opts=None):
    """rcond estimate from the Cholesky factor (LAPACK pocon
    semantics)."""
    from .potrf import potrs
    inv_est = _onenormest(
        lambda v: _vec_solve(lambda V: potrs(L, V, opts), L, v),
        lambda v: _vec_solve(lambda V: potrs(L, V, opts), L, v),
        L.n, cplx=L.dtype.is_complex)
    return _rcond(Anorm, inv_est)


def trcondest(norm_kind: Norm, A, opts=None):
    """rcond estimate of a triangular matrix (reference
    src/trcondest.cc)."""
    cplx = A.dtype.is_complex
    opT = conj_transpose if cplx else transpose
    Anorm = float(norm(Norm.One, A))
    inv_est = _onenormest(
        lambda v: _vec_solve(lambda V: trsm(Side.Left, 1.0, A, V, opts),
                             A, v),
        lambda v: _vec_solve(lambda V: trsm(Side.Left, 1.0, opT(A), V,
                                            opts), A, v),
        A.n, cplx=cplx)
    return _rcond(Anorm, inv_est)
