"""Hermitian eigensolver heev, the generalised hegst/hegv and the
tridiagonal kernels sterf, steqr, stedc (reference src/heev.cc:56-180,
src/hegst.cc, src/hegv.cc, src/sterf.cc, src/steqr2.cc, src/stedc.cc;
counterpart of ``slate_tpu/linalg/eig.py``).

Methods (``Option.MethodEig``): TwoStage, and QR/DC, which name the
tridiagonal stage of the two-stage pipeline (``linalg/he2hb.py``); Dense
is ``torch.linalg.eigh`` on the whole matrix, the counterpart of XLA's
``eigh``. Auto takes the two-stage pipeline on a p×q grid with at least
4 block columns and on one device from n = 24576, the JAX package's
dispatch (``eig.py:99``). Every routine here runs on a p×q grid: the
two-stage pipeline's p×q he2hb and back-transform, and hegst/hegv
through the p×q potrf, trsm, trmm and the mirror. The tridiagonal kernels run on
the host through scipy's LAPACK, as the reference runs them on one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import slate_error_if
from ..matrix import HermitianMatrix, Matrix, conj_transpose
from ..types import MethodEig, Option, Side, Uplo, get_option

# n from which Auto takes the two-stage pipeline on one device
TWO_STAGE_MIN_N = 24576


def _he_to_dense(A: HermitianMatrix) -> torch.Tensor:
    """The full symmetric matrix from the significant half."""
    d = A.to_dense()
    if A.uplo == Uplo.Upper:
        return torch.triu(d) + torch.triu(d, 1).mH
    return torch.tril(d) + torch.tril(d, -1).mH


def heev(A: HermitianMatrix, opts=None, want_vectors: bool = True,
         times=None):
    """Eigendecomposition A = Z·Λ·Zᴴ (reference src/heev.cc). Returns
    ``(lam, Z)``: lam ascending, a tensor of A's real dtype on A's
    device; Z a Matrix, or None without vectors. ``times``, a dict,
    receives the two-stage pipeline's stage seconds (``he2hb``,
    ``gather``, ``hb2st``, ``sterf`` or ``stedc``/``steqr``, the
    back-transforms; ``steqr`` above n = 512 also its ``sterf`` and
    ``stein``); the Dense method records none."""
    slate_error_if(A.m != A.n, "heev needs square")
    method = get_option(opts, Option.MethodEig, MethodEig.Auto)
    if method == MethodEig.Auto:
        two = (A.grid.size > 1 and A.nt >= 4) or A.n >= TWO_STAGE_MIN_N
    else:
        # QR and DC name the two-stage pipeline's tridiagonal stage; the
        # JAX package sends Bisection and MRRR to its dense path, the port
        # raises, so that a library eigensolver runs only under Dense and
        # Auto
        slate_error_if(method in (MethodEig.Bisection, MethodEig.MRRR),
                       f"heev: {method} has no pipeline of its own; use "
                       "MethodEig.DC, QR, TwoStage or Dense")
        two = method in (MethodEig.TwoStage, MethodEig.QR, MethodEig.DC)
    if two:
        from .he2hb import heev_two_stage
        if A.uplo == Uplo.Upper:
            # the stored Upper half mirrored into Lower storage: the same
            # operator, so Λ and Z are unchanged
            G = Matrix(data=A.data, m=A.m, n=A.n, nb=A.nb, grid=A.grid)
            low = conj_transpose(G).materialize().data
            A = HermitianMatrix(data=low, m=A.m, n=A.n, nb=A.nb,
                                grid=A.grid, uplo=Uplo.Lower)
        return heev_two_stage(A, opts, want_vectors, times)
    full = _he_to_dense(A)
    if not want_vectors:
        return torch.linalg.eigvalsh(full), None
    lam, z = torch.linalg.eigh(full)
    return lam, Matrix.from_dense(z, nb=A.nb, grid=A.grid)


def hegst(itype: int, A: HermitianMatrix, L, opts=None) -> HermitianMatrix:
    """Reduce the generalised problem to standard form (reference
    src/hegst.cc, ``eig.py:125-141``), L the lower Cholesky factor of B:
    itype 1, A ← L⁻¹·A·L⁻ᴴ by two ``trsm`` (the left one a lower solve,
    so K3 takes its tiles); itype 2 and 3, A ← Lᴴ·A·L by two ``trmm``.
    Both triangles of the result are stored."""
    from ..ops.blas import _mirror_full, trmm, trsm
    slate_error_if(itype not in (1, 2, 3), f"hegst: itype {itype} not in "
                   "1, 2, 3")
    Af = _mirror_full(A, conj=A.dtype.is_complex)
    if itype == 1:
        Y = trsm(Side.Left, 1.0, L, Af, opts)
        C = trsm(Side.Right, 1.0, conj_transpose(L), Y, opts)
    else:
        Y = trmm(Side.Left, 1.0, conj_transpose(L), Af, opts)
        C = trmm(Side.Right, 1.0, L, Y, opts)
    return HermitianMatrix(data=C.data, m=A.m, n=A.n, nb=A.nb, grid=A.grid,
                           uplo=A.uplo)


def hegv(itype: int, A: HermitianMatrix, B: HermitianMatrix, opts=None):
    """Generalised symmetric-definite eigensolver (reference src/hegv.cc,
    ``eig.py:144-156``): B = L·Lᴴ by ``potrf``, the reduction by
    :func:`hegst`, :func:`heev` of the result, and the back-transform
    x = L⁻ᴴ·y (itype 1 and 2) or x = L·y (itype 3). itype 1 solves
    A·x = λ·B·x, 2 A·B·x = λ·x, 3 B·A·x = λ·x. Returns ``(lam, Z, info)``
    with ``info`` potrf's. When B is not positive definite, lam and Z are
    NaN, as the JAX package's come out, and heev is not run. Real and
    complex dtypes; lam comes out in the real dtype."""
    from ..ops.blas import trmm, trsm
    from .potrf import potrf
    L, info = potrf(B, opts)
    if L.uplo == Uplo.Upper:
        # B = Uᴴ·U: the reduction takes the lower factor L = Uᴴ
        L = conj_transpose(L).materialize()
    if int(info) != 0:
        real = A.dtype.to_real() if A.dtype.is_complex else A.dtype
        nan = torch.full((A.n, A.n), float("nan"), dtype=A.dtype,
                         device=A.data.device)
        return (torch.full((A.n,), float("nan"), dtype=real,
                           device=A.data.device),
                Matrix.from_dense(nan, nb=A.nb, grid=A.grid), info)
    C = hegst(itype, A, L, opts)
    lam, Z = heev(C, opts)
    if Z.nb != L.nb:
        # the two-stage heev returns Z at Option.EigBand's tile size;
        # the back-transform runs at L's
        Z = Matrix.from_dense(Z.to_dense(), nb=L.nb, grid=L.grid)
    if itype in (1, 2):
        Z = trsm(Side.Left, 1.0, conj_transpose(L), Z, opts)
    else:
        Z = trmm(Side.Left, 1.0, L, Z, opts)
    return lam, Z, info


# ---------------------------------------------------------------------------
# tridiagonal kernels (host, like the reference's rank-0 sterf/steqr2)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).cpu(), np.float64)


def sterf(d, e) -> np.ndarray:
    """Eigenvalues of the symmetric tridiagonal (d, e), ascending, as a
    float64 numpy array (reference src/sterf.cc)."""
    from scipy.linalg import eigvalsh_tridiagonal
    return eigvalsh_tridiagonal(_host(d), _host(e))


def steqr(d, e, want_vectors: bool = True, device=None, dtype=None,
          times=None):
    """Tridiagonal QR iteration (reference src/steqr2.cc): ``(lam, Z |
    None)``, lam ascending as a float64 numpy array. Without ``device``,
    Z comes from the host's LAPACK as a float64 numpy array. With a
    ``device`` and vectors, the JAX package's device branch (its
    ``steqr(..., grid=)``): the eigenvalues by host QR iteration
    (:func:`sterf`, O(n) memory) and Z, a ``dtype`` tensor on ``device``,
    by batched inverse iteration there (``linalg/stein.py``). ``times``,
    a dict, receives that branch's ``sterf`` and ``stein`` seconds."""
    if device is not None and want_vectors:
        from .he2hb import _StageClock
        from .stein import stein_vectors
        clock = _StageClock(times, device)
        lam = clock("sterf", sterf, d, e)
        return lam, clock("stein", stein_vectors, _host(d), _host(e), lam,
                          device, dtype)
    from scipy.linalg import eigh_tridiagonal
    d, e = _host(d), _host(e)
    if want_vectors:
        return eigh_tridiagonal(d, e)
    return eigh_tridiagonal(d, e, eigvals_only=True), None


def stedc(d, e, want_vectors: bool = True, device=None, dtype=None):
    """Divide & conquer tridiagonal eigensolver (reference src/stedc.cc;
    ``linalg/stedc.py``): ``(lam, Z | None)``, Z accumulated on
    ``device`` when one is given."""
    from .stedc import stedc as _stedc
    return _stedc(d, e, want_vectors, device=device, dtype=dtype)
