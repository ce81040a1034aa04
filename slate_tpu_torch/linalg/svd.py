"""SVD: gesvd (reference src/gesvd.cc:77-102; counterpart of
``slate_tpu/linalg/svd.py``). ``Option.MethodSVD``: TwoStage is the
ge2tb → tb2bd → bdsqr pipeline of ``linalg/ge2tb.py``; Dense is
``torch.linalg.svd`` on the whole matrix (cuSOLVER's ``gesvd`` driver on
the card), the counterpart of XLA's SVD.
The other methods raise, where the JAX package sends them to its dense
path: a library SVD runs only under Dense and Auto. Auto takes the
two-stage pipeline on a p×q grid with at least 4 block rows and columns
and on one device from min(m, n) = 12288, the JAX package's dispatch
(``svd.py:43-44``); on a p×q grid a wide input goes through the
block-cyclic transpose."""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..matrix import Matrix, conj_transpose
from ..types import MethodSVD, Option, get_option

# min(m, n) from which Auto takes the two-stage pipeline on one device
TWO_STAGE_MIN_N = 12288


def gesvd(A: Matrix, opts=None, want_u: bool = False, want_vt: bool = False,
          times=None):
    """Singular values, and optionally vectors, of A. Returns
    ``(s, U | None, VT | None)``: s descending, a tensor of A's real dtype
    on its device; U [m, k] and VT [k, n] Matrices, k = min(m, n).
    ``times``, a dict, receives the two-stage pipeline's stage seconds;
    the Dense method records none."""
    method = get_option(opts, Option.MethodSVD, MethodSVD.Auto)
    slate_error_if(method not in (MethodSVD.Auto, MethodSVD.Dense,
                                  MethodSVD.TwoStage),
                   f"gesvd: {method} has no pipeline of its own; use "
                   "MethodSVD.TwoStage or MethodSVD.Dense")
    if method == MethodSVD.Auto:
        two = ((A.grid.size > 1 and min(A.mt, A.nt) >= 4)
               or min(A.m, A.n) >= TWO_STAGE_MIN_N)
    else:
        two = method == MethodSVD.TwoStage
    Am = A.materialize()
    if two:
        from .ge2tb import gesvd_two_stage
        if Am.m >= Am.n:
            return gesvd_two_stage(Am, opts, want_u, want_vt, times)
        # m < n: Aᵀ = U'·Σ·V'ᵀ (tall), so A = V'·Σ·U'ᵀ — the reference
        # reaches wide inputs through the transpose too
        s, U2, VT2 = gesvd_two_stage(conj_transpose(Am).materialize(), opts,
                                     want_vt, want_u, times)
        U = conj_transpose(VT2).materialize() if want_u else None
        VT = conj_transpose(U2).materialize() if want_vt else None
        return s, U, VT
    d = Am.to_dense()
    # on the card, cuSOLVER's QR-iteration SVD: the default (Jacobi)
    # driver read 1.3e4·u (complex64) and 3.6e4·u (complex128) of σ_max
    # on a Hermitian 4096 matrix, gesvd 1.0·u and 104·u in under half the
    # time (tools/svd_drivers.py; NVIDIA H100 80GB HBM3, 700 W)
    drv = {"driver": "gesvd"} if d.is_cuda else {}
    if not (want_u or want_vt):
        return torch.linalg.svdvals(d, **drv), None, None
    u, s, vt = torch.linalg.svd(d, full_matrices=False, **drv)
    U = Matrix.from_dense(u, nb=A.nb, grid=A.grid) if want_u else None
    VT = Matrix.from_dense(vt, nb=A.nb, grid=A.grid) if want_vt else None
    return s, U, VT
