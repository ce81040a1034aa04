"""Symmetric eigensolver heev and the tridiagonal kernels sterf, steqr,
stedc (reference src/heev.cc:56-180, src/sterf.cc, src/steqr2.cc,
src/stedc.cc; counterpart of ``slate_tpu/linalg/eig.py``).

Methods (``Option.MethodEig``): TwoStage, and QR/DC, which name the
tridiagonal stage of the two-stage pipeline (``linalg/he2hb.py``); Dense
is ``torch.linalg.eigh`` on the whole matrix, the counterpart of XLA's
``eigh``. Auto takes the two-stage pipeline on one device from
n = 24576, the JAX package's threshold. The tridiagonal kernels run on
the host through scipy's LAPACK, as the reference runs them on one rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import SlateError, slate_error_if
from ..matrix import HermitianMatrix, Matrix, conj_transpose
from ..types import MethodEig, Option, Uplo, get_option

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
    """Eigendecomposition A = Z·Λ·Zᵀ (reference src/heev.cc). Returns
    ``(lam, Z)``: lam ascending, a tensor of A's real dtype on A's
    device; Z a Matrix, or None without vectors. ``times``, a dict,
    receives the two-stage pipeline's stage seconds (``he2hb``,
    ``gather``, ``hb2st``, ``sterf`` or ``stedc``/``steqr``, the
    back-transforms); the Dense method records none."""
    slate_error_if(A.m != A.n, "heev needs square")
    method = get_option(opts, Option.MethodEig, MethodEig.Auto)
    if method == MethodEig.Auto:
        two = A.n >= TWO_STAGE_MIN_N
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


def hegst(itype: int, A, L, opts=None):
    """Reduction of the generalised problem to standard form (reference
    src/hegst.cc): not ported yet (itype 2 and 3 need trmm)."""
    raise SlateError("hegst is not ported yet (ROADMAP A8)")


def hegv(itype: int, A, B, opts=None):
    """Generalised symmetric eigensolver (reference src/hegv.cc): not
    ported yet; it waits for hegst."""
    raise SlateError("hegv is not ported yet (ROADMAP A8)")


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


def steqr(d, e, want_vectors: bool = True):
    """Tridiagonal QR iteration with vectors on the host (reference
    src/steqr2.cc): ``(lam, Z | None)`` as float64 numpy arrays. The JAX
    package's device inverse iteration (``stein``), which it takes with a
    grid, is not ported yet."""
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
