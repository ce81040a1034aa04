"""Mixed-precision solvers with iterative refinement (reference
src/gesv_mixed.cc, src/posv_mixed.cc, src/gesv_mixed_gmres.cc,
src/posv_mixed_gmres.cc; counterpart of ``slate_tpu/linalg/mixed.py``).

Factor in low precision, refine the residual in the working precision,
and fall back to a full-precision factorization if refinement stalls
after ``Option.MaxIterations`` sweeps (``Option.UseFallbackSolver``).

The low leg (:func:`_lo_plan`): f64 inputs lower their storage to f32,
the reference's double/single pair, so an f64 solve factors on the
port's f32 kernels; f32 inputs keep f32 storage and factor with
``bf16_3x`` trailing updates (``internal/precision.py``), while panels
and triangular solves stay at full FP32, so a few sweeps recover
f32-level backward error. The residual B − A·X always runs at the
working precision and the default tier. The loop runs on the host and
drives the device's factorization and solves, as the reference's
driver loop does; the GMRES Hessenberg least-squares problem is solved
on the host in numpy.

On a p×q grid the legs are the p×q ``getrf``/``potrf`` (at the low
leg's tier), ``getrs``/``potrs``, ``gemm``, ``norm`` and ``add``, and the
GMRES inner products sum every rank's slots (the padding is zero on
every rank), as the JAX package's ``mixed.py:59-266`` does on a mesh.

Whether the last solve on this thread took the full-precision fallback
is read with :func:`used_fallback`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..internal import comm
from ..matrix import HermitianMatrix, Matrix
from ..ops.blas import gemm
from ..ops.elementwise import add
from ..ops.norms import norm
from ..types import Norm, Op, Option, get_option
from . import getrf as _getrf
from . import potrf as _potrf

_LOWER = {torch.float64: torch.float32, torch.complex128: torch.complex64}

_STATE = threading.local()


def used_fallback() -> bool:
    """True when the last mixed solve on this thread stalled and took
    the full-precision fallback solver."""
    return getattr(_STATE, "fallback", False)


def _lo_plan(dt, opts):
    """``(factor_dtype, factor_opts)`` of the low-precision leg: f64/c128
    lower the storage (f32/c64) and keep the caller's opts; f32/c64 keep
    the storage dtype and add ``Option.TrailingPrecision: "bf16_3x"``
    unless the caller pinned a tier."""
    if dt in _LOWER:
        return _LOWER[dt], opts
    lo_opts = dict(opts) if opts else {}
    lo_opts.setdefault(Option.TrailingPrecision, "bf16_3x")
    return dt, lo_opts


def _stop(A, B) -> float:
    """‖A‖_∞·ε·√n, the stop test's scale (gesv_mixed.cc)."""
    eps = float(torch.finfo(B.dtype).eps)
    return float(norm(Norm.Inf, A)) * eps * (A.n ** 0.5)


def _ir_loop(A, B, factor_lo, solve_lo, solve_hi, opts):
    """Iterative refinement (reference gesv_mixed.cc): returns
    ``(X, iters, converged)``. Stops once
    ‖R‖_max ≤ ‖A‖_∞·ε·√n·max(‖X‖_max, 1)."""
    itermax = get_option(opts, Option.MaxIterations, 30)
    use_fallback = get_option(opts, Option.UseFallbackSolver, True)
    _STATE.fallback = False
    stop = _stop(A, B)
    lo_factors = factor_lo()
    X = solve_lo(lo_factors, B).astype(B.dtype)
    iters = 0
    for it in range(itermax):
        R = gemm(-1.0, A, X, 1.0, B)               # working precision
        rnorm = float(norm(Norm.Max, R))
        xnorm = float(norm(Norm.Max, X))
        if rnorm <= stop * max(xnorm, 1.0):
            return X, it, True
        D = solve_lo(lo_factors, R).astype(B.dtype)
        X = add(1.0, D, 1.0, X)
        iters = it + 1
    # IR stalled: the full-precision fallback (gesv_mixed.cc:33-47)
    if use_fallback:
        _STATE.fallback = True
        return solve_hi(B), iters, False
    return X, iters, False


def _lu_legs(A, opts, info_box, set_info_hi: bool):
    lo, lo_opts = _lo_plan(A.dtype, opts)

    def factor_lo():
        LU, piv, info = _getrf.getrf(A.astype(lo), lo_opts)
        info_box["info"] = info
        return LU, piv

    def solve_lo(f, R):
        LU, piv = f
        return _getrf.getrs(LU, piv, R.astype(lo), Op.NoTrans, opts)

    def solve_hi(B_):
        X, _, _, info = _getrf.gesv(A, B_, opts)
        if set_info_hi:
            info_box["info"] = info
        return X

    return factor_lo, solve_lo, solve_hi


def _chol_legs(A, opts, info_box, set_info_hi: bool):
    lo, lo_opts = _lo_plan(A.dtype, opts)

    def factor_lo():
        L, info = _potrf.potrf(A.astype(lo), lo_opts)
        info_box["info"] = info
        return L

    def solve_lo(L, R):
        return _potrf.potrs(L, R.astype(lo), opts)

    def solve_hi(B_):
        X, _, info = _potrf.posv(A, B_, opts)
        if set_info_hi:
            info_box["info"] = info
        return X

    return factor_lo, solve_lo, solve_hi


def gesv_mixed(A: Matrix, B: Matrix, opts=None):
    """LU in low precision and IR in working precision (reference
    src/gesv_mixed.cc). Returns ``(X, iters, info)``."""
    info_box = {}
    X, iters, _ = _ir_loop(A, B, *_lu_legs(A, opts, info_box, True), opts)
    return X, iters, info_box.get("info")


def posv_mixed(A: HermitianMatrix, B: Matrix, opts=None):
    """Cholesky in low precision and IR (reference src/posv_mixed.cc).
    Returns ``(X, iters, info)``."""
    info_box = {}
    X, iters, _ = _ir_loop(A, B, *_chol_legs(A, opts, info_box, True),
                           opts)
    return X, iters, info_box.get("info")


# ---------------------------------------------------------------------------
# GMRES-IR (reference src/gesv_mixed_gmres.cc / posv_mixed_gmres.cc):
# right-preconditioned restarted GMRES in working precision with the
# low-precision factorization as the preconditioner
# ---------------------------------------------------------------------------

def _scaled(V, s):
    return V._replace(data=V.data * s)


def _dot(U, V) -> torch.Tensor:
    """⟨U, V⟩, the Frobenius inner product of two same-shape matrices on
    one grid: each rank's sum over its slots, then the sum over the ranks
    (the padding is zero on every rank)."""
    prod = U.data.conj() * V.data
    if U.grid.size == 1:
        return prod.sum()
    return comm.psum_all(prod.sum(dim=(2, 3, 4, 5)))[0, 0]


def _gmres_ir(A, B, factor_lo, solve_lo, solve_hi, opts,
              restart: int = 30):
    itermax = get_option(opts, Option.MaxIterations, 30)
    _STATE.fallback = False
    stop = _stop(A, B)
    lo_factors = factor_lo()
    X = solve_lo(lo_factors, B).astype(B.dtype)
    cplx = B.dtype.is_complex
    as_scalar = complex if cplx else float
    hdt = np.complex128 if cplx else np.float64

    def matvec(V):
        out = Matrix.zeros(A.m, V.n, A.nb, A.grid, dtype=B.dtype)
        return gemm(1.0, A, V, 0.0, out)

    for outer in range(itermax):
        R = gemm(-1.0, A, X, 1.0, B)
        beta = float(norm(Norm.Fro, R))
        xnorm = float(norm(Norm.Max, X))
        if beta <= stop * max(xnorm, 1.0):
            return X, outer, True
        # Arnoldi with the preconditioned operator A·M⁻¹
        Vs = [_scaled(R, 1.0 / beta)]
        H = np.zeros((restart + 1, restart), hdt)
        for j in range(restart):
            Z = solve_lo(lo_factors, Vs[j]).astype(B.dtype)
            W = matvec(Z)
            for i in range(j + 1):
                hij = as_scalar(_dot(Vs[i], W))
                H[i, j] = hij
                W = add(-hij, Vs[i], 1.0, W)
            hn = float(norm(Norm.Fro, W))
            H[j + 1, j] = hn
            if hn < 1e-30:
                break
            Vs.append(_scaled(W, 1.0 / hn))
        k = len(Vs) - 1
        if k == 0:
            # Arnoldi broke down at once: the preconditioner solves the
            # residual (nearly) exactly, so take a plain IR step
            D = solve_lo(lo_factors, R).astype(B.dtype)
            X = add(1.0, D, 1.0, X)
            continue
        e1 = np.zeros(k + 1, hdt)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[:k + 1, :k], e1, rcond=None)
        Zsum = _scaled(Vs[0], as_scalar(y[0]))
        for i in range(1, k):
            Zsum = add(as_scalar(y[i]), Vs[i], 1.0, Zsum)
        D = solve_lo(lo_factors, Zsum).astype(B.dtype)
        X = add(1.0, D, 1.0, X)
    _STATE.fallback = True
    return solve_hi(B), itermax, False


def gesv_mixed_gmres(A: Matrix, B: Matrix, opts=None):
    """GMRES-IR LU solver (reference src/gesv_mixed_gmres.cc). Returns
    ``(X, iters, info)``."""
    info_box = {}
    X, iters, _ = _gmres_ir(A, B, *_lu_legs(A, opts, info_box, False),
                            opts)
    return X, iters, info_box.get("info")


def posv_mixed_gmres(A: HermitianMatrix, B: Matrix, opts=None):
    """GMRES-IR Cholesky solver (reference src/posv_mixed_gmres.cc).
    Returns ``(X, iters, info)``."""
    info_box = {}
    X, iters, _ = _gmres_ir(A, B, *_chol_legs(A, opts, info_box, False),
                            opts)
    return X, iters, info_box.get("info")
