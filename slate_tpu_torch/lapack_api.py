"""LAPACK-compatibility API (reference lapack_api/, lapack_slate.hh;
counterpart of ``slate_tpu/lapack_api.py``).

One shim family per reference lapack_api/lapack_<name>.cc file: gemm,
hemm, symm, herk, syrk, her2k, syr2k, trmm, trsm (BLAS-3); lange, lanhe,
lansy, lantr (norms); gesv, gesv_mixed, getrf, getrs, getri (LU); posv,
potrf, potrs, potri (Cholesky); gels, geqrf (least squares); syev/heev
and gesvd. Names, argument order and results are the JAX package's:
``slate_<s|d|c|z><name>``, numpy in and numpy out, ``info`` by LAPACK's
convention (0 = success).

Each shim takes a keyword ``grid=None``: the matrices go to
:func:`~.grid.default_grid`, ``Grid(1, 1)`` on the CUDA card (which raises
without one), unless the caller names another, e.g. ``Grid(1, 1,
device="cpu")``. No shim falls back to the CPU by itself. The c/z shims
run the drivers in complex64/complex128, ``slate_{c,z}heev`` and
``slate_{c,z}gesvd`` included (their eigen- and singular values come out
in the real dtype).

Like the reference's shims, these trade speed for drop-in convenience
(every call copies numpy to the device and back); callers of the port
should use the Matrix API.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .compat_flags import (apply_op_char as _apply_op,
                           diag_from_char as _diag,
                           mirror_triangle_np as _mirror_np,
                           norm_from_char as _norm_kind,
                           op_from_char as _op,
                           side_from_char as _side,
                           uplo_from_char as _uplo)
from .errors import slate_error_if as _error_if
from .grid import default_grid
from .matrix import (HermitianMatrix, Matrix, SymmetricMatrix,
                     TriangularMatrix)
from .types import Diag, Uplo

_PREFIX_DTYPE = {"s": np.float32, "d": np.float64,
                 "c": np.complex64, "z": np.complex128}


def _default_nb(a):
    return min(512, max(32, max(a.shape) // 8))


def _ingest(a, dtype, grid, cls=Matrix, nb=None, **kw):
    a = np.asarray(a, dtype)
    return cls.from_dense(a, nb=nb or _default_nb(a),
                          grid=grid or default_grid(), **kw)


def _rhs(b, dtype):
    """B as a 2-D array: a vector becomes one column."""
    return np.atleast_2d(np.asarray(b, dtype).T).T


def _out(M) -> np.ndarray:
    return M.to_dense().cpu().numpy()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ipiv(piv) -> np.ndarray:
    """LAPACK ipiv ``[kt, nb]`` int32 of the port's pivots (a
    ``PivotOrder`` is converted as ``pivot_order_to_ipiv`` does)."""
    from .linalg.getrf import PivotOrder, pivot_order_to_ipiv
    if isinstance(piv, PivotOrder):
        piv = pivot_order_to_ipiv(piv)
    return _np(piv).astype(np.int32)


def _piv2d(piv, nb, n=None):
    """Reshape a flat ipiv (from slate_?getrf) back to [kt, nb].

    The pivot grouping is only meaningful at the nb getrf used; a caller
    who lets getrs/getri re-derive a different default nb would silently
    regroup the pivots whenever the lengths happen to divide, so a
    mismatch raises instead."""
    piv = np.asarray(piv, np.int32)
    if piv.ndim != 1:
        # 2-D pivots carry the factor's nb in their shape
        _error_if(
            piv.shape[1] != nb,
            f"pivot blocking {piv.shape[1]} does not match this "
            f"factor's nb={nb} (use the same nb for getrf and "
            "getrs/getri)")
        return piv
    kt = -(-n // nb) if n is not None else piv.size // nb
    _error_if(
        piv.size != kt * nb,
        f"ipiv length {piv.size} does not match the factor's blocking "
        f"(expected {kt}*{nb}; pass the getrf nb to getrs/getri)")
    return piv.reshape(-1, nb)


def _shim(pre, name, fn):
    """Name ``fn`` ``slate_<pre><name>``."""
    fn.__name__ = fn.__qualname__ = f"slate_{pre}{name}"
    return fn


def _make_gesv(pre):
    dt = _PREFIX_DTYPE[pre]

    def gesv(a, b, nb=None, *, grid=None):
        """Solve A·X=B (LAPACK ?gesv). Returns (x, info)."""
        from .linalg.getrf import gesv as _gesv
        A = _ingest(a, dt, grid, nb=nb)
        B = _ingest(_rhs(b, dt), dt, A.grid, nb=A.nb)
        X, LU, piv, info = _gesv(A, B)
        return _out(X), int(info)
    return _shim(pre, "gesv", gesv)


def _make_posv(pre):
    dt = _PREFIX_DTYPE[pre]

    def posv(uplo, a, b, nb=None, *, grid=None):
        """Solve A·X=B, A Hermitian positive definite (LAPACK ?posv).
        Returns (x, info)."""
        from .linalg.potrf import posv as _posv
        A = _ingest(a, dt, grid, HermitianMatrix, nb=nb, uplo=_uplo(uplo))
        B = _ingest(_rhs(b, dt), dt, A.grid, nb=A.nb)
        X, L, info = _posv(A, B)
        return _out(X), int(info)
    return _shim(pre, "posv", posv)


def _make_potrf(pre):
    dt = _PREFIX_DTYPE[pre]

    def potrf(uplo, a, nb=None, *, grid=None):
        """Cholesky factor (LAPACK ?potrf). Returns (factor, info), the
        factor's other triangle zero."""
        from .linalg.potrf import potrf as _potrf
        u = _uplo(uplo)
        A = _ingest(a, dt, grid, HermitianMatrix, nb=nb, uplo=u)
        L, info = _potrf(A)
        out = _out(L)
        out = np.tril(out) if u == Uplo.Lower else np.triu(out)
        return out, int(info)
    return _shim(pre, "potrf", potrf)


def _make_getrf(pre):
    dt = _PREFIX_DTYPE[pre]

    def getrf(a, nb=None, *, grid=None):
        """LU factor (LAPACK ?getrf). Returns (lu, piv, info); piv is the
        [kt, nb] pivot array, whose shape carries the factor's blocking
        so that getrs/getri detect an nb mismatch. ``piv.reshape(-1)``
        is the flat LAPACK ipiv (0-based)."""
        from .linalg.getrf import getrf as _getrf
        A = _ingest(a, dt, grid, nb=nb)
        LU, piv, info = _getrf(A)
        return _out(LU), _ipiv(piv), int(info)
    return _shim(pre, "getrf", getrf)


def _make_getrs(pre):
    dt = _PREFIX_DTYPE[pre]

    def getrs(trans, lu, piv, b, nb=None, *, grid=None):
        """Solve op(A)·X=B from getrf factors (LAPACK ?getrs). ``piv`` is
        the ipiv of slate_?getrf at the same ``nb``. Returns x."""
        from .linalg.getrf import getrs as _getrs
        LU = _ingest(lu, dt, grid, nb=nb)
        B = _ingest(_rhs(b, dt), dt, LU.grid, nb=LU.nb)
        p = torch.from_numpy(_piv2d(piv, LU.nb, LU.n))
        return _out(_getrs(LU, p, B, _op(trans)))
    return _shim(pre, "getrs", getrs)


def _make_getri(pre):
    dt = _PREFIX_DTYPE[pre]

    def getri(lu, piv, nb=None, *, grid=None):
        """A⁻¹ from getrf factors (LAPACK ?getri)."""
        from .linalg.trtri import getri as _getri
        LU = _ingest(lu, dt, grid, nb=nb)
        p = torch.from_numpy(_piv2d(piv, LU.nb, LU.n))
        return _out(_getri(LU, p))
    return _shim(pre, "getri", getri)


def _make_gesv_mixed(pre):
    dt = _PREFIX_DTYPE[pre]

    def gesv_mixed(a, b, nb=None, *, grid=None):
        """Mixed-precision solve with iterative refinement (LAPACK
        dsgesv/zcgesv analog). Returns (x, iters, info)."""
        from .linalg.mixed import gesv_mixed as _gm
        A = _ingest(a, dt, grid, nb=nb)
        B = _ingest(_rhs(b, dt), dt, A.grid, nb=A.nb)
        X, iters, info = _gm(A, B)
        return _out(X), int(iters), int(info)
    return _shim(pre, "gesv_mixed", gesv_mixed)


def _make_potrs(pre):
    dt = _PREFIX_DTYPE[pre]

    def potrs(uplo, l, b, nb=None, *, grid=None):
        """Solve from the Cholesky factor (LAPACK ?potrs)."""
        from .linalg.potrf import potrs as _potrs
        L = _ingest(l, dt, grid, TriangularMatrix, nb=nb, uplo=_uplo(uplo),
                    diag=Diag.NonUnit)
        B = _ingest(_rhs(b, dt), dt, L.grid, nb=L.nb)
        return _out(_potrs(L, B))
    return _shim(pre, "potrs", potrs)


def _make_potri(pre):
    dt = _PREFIX_DTYPE[pre]

    def potri(uplo, l, nb=None, *, grid=None):
        """A⁻¹ from the Cholesky factor (LAPACK ?potri). Returns the full
        inverse (both halves populated)."""
        from .linalg.trtri import potri as _potri
        L = _ingest(l, dt, grid, TriangularMatrix, nb=nb, uplo=_uplo(uplo),
                    diag=Diag.NonUnit)
        Ainv = _potri(L)
        return _mirror_np(_out(Ainv), Ainv.uplo)
    return _shim(pre, "potri", potri)


def _make_geqrf(pre):
    dt = _PREFIX_DTYPE[pre]

    def geqrf(a, nb=None, *, grid=None):
        """QR factor (LAPACK ?geqrf). Returns (qr, T)."""
        from .linalg.geqrf import geqrf as _geqrf
        A = _ingest(a, dt, grid, nb=nb)
        QR, T = _geqrf(A)
        return _out(QR), _np(T)
    return _shim(pre, "geqrf", geqrf)


def _make_gels(pre):
    dt = _PREFIX_DTYPE[pre]

    def gels(a, b, nb=None, *, grid=None):
        """Least squares / minimum norm (LAPACK ?gels). Returns x."""
        from .linalg.geqrf import gels as _gels
        A = _ingest(a, dt, grid, nb=nb)
        B = _ingest(_rhs(b, dt), dt, A.grid, nb=A.nb)
        return _out(_gels(A, B))
    return _shim(pre, "gels", gels)


def _make_gemm(pre):
    dt = _PREFIX_DTYPE[pre]

    def gemm(transa, transb, alpha, a, b, beta, c, nb=None, *, grid=None):
        """C = α·op(A)·op(B) + β·C (LAPACK ?gemm)."""
        from .ops.blas import gemm as _gemm
        A = _apply_op(_ingest(a, dt, grid, nb=nb), transa)
        B = _apply_op(_ingest(b, dt, A.grid, nb=nb), transb)
        C = _ingest(c, dt, A.grid, nb=A.nb)
        return _out(_gemm(alpha, A, B, beta, C))
    return _shim(pre, "gemm", gemm)


def _make_syev(pre, name):
    dt = _PREFIX_DTYPE[pre]

    def syev(jobz, uplo, a, nb=None, *, grid=None):
        """Eigenvalues and, for jobz 'V', eigenvectors (LAPACK
        ?syev/?heev). Returns (w, z or None, info)."""
        from .linalg.eig import heev as _heev
        A = _ingest(a, dt, grid, HermitianMatrix, nb=nb, uplo=_uplo(uplo))
        want = str(jobz).lower().startswith("v")
        lam, Z = _heev(A, want_vectors=want)
        return _np(lam), (_out(Z) if want else None), 0
    return _shim(pre, name, syev)


def _make_gesvd(pre):
    dt = _PREFIX_DTYPE[pre]

    def gesvd(jobu, jobvt, a, nb=None, *, grid=None):
        """Singular values and, unless job 'N', vectors (LAPACK ?gesvd).
        Returns (s, u or None, vt or None, info)."""
        from .linalg.svd import gesvd as _gesvd
        A = _ingest(a, dt, grid, nb=nb)
        wu = str(jobu).lower() != "n"
        wv = str(jobvt).lower() != "n"
        s, U, VT = _gesvd(A, want_u=wu, want_vt=wv)
        return _np(s), (_out(U) if wu else None), (_out(VT) if wv else None), 0
    return _shim(pre, "gesvd", gesvd)


def _make_lange(pre):
    dt = _PREFIX_DTYPE[pre]

    def lange(norm_k, a, nb=None, *, grid=None):
        """General-matrix norm (LAPACK ?lange)."""
        from .ops.norms import norm as _norm
        return float(_norm(_norm_kind(norm_k), _ingest(a, dt, grid, nb=nb)))
    return _shim(pre, "lange", lange)


def _make_lanhe(pre, name):
    dt = _PREFIX_DTYPE[pre]
    cls = HermitianMatrix if name == "lanhe" else SymmetricMatrix

    def lanhe(norm_k, uplo, a, nb=None, *, grid=None):
        """Hermitian/symmetric-matrix norm (LAPACK ?lanhe/?lansy)."""
        from .ops.norms import norm as _norm
        A = _ingest(a, dt, grid, cls, nb=nb, uplo=_uplo(uplo))
        return float(_norm(_norm_kind(norm_k), A))
    return _shim(pre, name, lanhe)


def _make_lantr(pre):
    dt = _PREFIX_DTYPE[pre]

    def lantr(norm_k, uplo, diag, a, nb=None, *, grid=None):
        """Triangular-matrix norm (LAPACK ?lantr)."""
        from .ops.norms import norm as _norm
        A = _ingest(a, dt, grid, TriangularMatrix, nb=nb, uplo=_uplo(uplo),
                    diag=_diag(diag))
        return float(_norm(_norm_kind(norm_k), A))
    return _shim(pre, "lantr", lantr)


def _make_hemm(pre, name):
    dt = _PREFIX_DTYPE[pre]
    cls = HermitianMatrix if name == "hemm" else SymmetricMatrix

    def hemm(side, uplo, alpha, a, b, beta, c, nb=None, *, grid=None):
        """C = α·A·B + β·C or α·B·A + β·C with A Hermitian/symmetric
        (LAPACK ?hemm/?symm)."""
        from .ops import blas
        fn = blas.hemm if name == "hemm" else blas.symm
        A = _ingest(a, dt, grid, cls, nb=nb, uplo=_uplo(uplo))
        B = _ingest(b, dt, A.grid, nb=A.nb)
        C = _ingest(c, dt, A.grid, nb=A.nb)
        return _out(fn(_side(side), alpha, A, B, beta, C))
    return _shim(pre, name, hemm)


def _make_herk(pre, name):
    dt = _PREFIX_DTYPE[pre]
    cls = HermitianMatrix if name == "herk" else SymmetricMatrix

    def herk(uplo, trans, alpha, a, beta, c, nb=None, *, grid=None):
        """C = α·op(A)·op(A)ᴴ + β·C (LAPACK ?herk/?syrk)."""
        from .ops import blas
        fn = blas.herk if name == "herk" else blas.syrk
        A = _apply_op(_ingest(a, dt, grid, nb=nb), trans)
        C = _ingest(c, dt, A.grid, cls, nb=A.nb, uplo=_uplo(uplo))
        return _out(fn(alpha, A, beta, C))
    return _shim(pre, name, herk)


def _make_her2k(pre, name):
    dt = _PREFIX_DTYPE[pre]
    cls = HermitianMatrix if name == "her2k" else SymmetricMatrix

    def her2k(uplo, trans, alpha, a, b, beta, c, nb=None, *, grid=None):
        """C = α·op(A)·op(B)ᴴ + ᾱ·op(B)·op(A)ᴴ + β·C (?her2k/?syr2k)."""
        from .ops import blas
        fn = blas.her2k if name == "her2k" else blas.syr2k
        A = _apply_op(_ingest(a, dt, grid, nb=nb), trans)
        B = _apply_op(_ingest(b, dt, A.grid, nb=nb), trans)
        C = _ingest(c, dt, A.grid, cls, nb=A.nb, uplo=_uplo(uplo))
        return _out(fn(alpha, A, B, beta, C))
    return _shim(pre, name, her2k)


def _make_trmm(pre):
    dt = _PREFIX_DTYPE[pre]

    def trmm(side, uplo, transa, diag, alpha, a, b, nb=None, *, grid=None):
        """B = α·op(A)·B or α·B·op(A), A triangular (LAPACK ?trmm)."""
        from .ops.blas import trmm as _trmm
        A = _ingest(a, dt, grid, TriangularMatrix, nb=nb, uplo=_uplo(uplo),
                    diag=_diag(diag))
        B = _ingest(b, dt, A.grid, nb=A.nb)
        return _out(_trmm(_side(side), alpha, _apply_op(A, transa), B))
    return _shim(pre, "trmm", trmm)


def _make_trsm(pre):
    dt = _PREFIX_DTYPE[pre]

    def trsm(side, uplo, transa, diag, alpha, a, b, nb=None, *, grid=None):
        """Solve op(A)·X = α·B or X·op(A) = α·B (LAPACK ?trsm)."""
        from .ops.blas import trsm as _trsm
        A = _ingest(a, dt, grid, TriangularMatrix, nb=nb, uplo=_uplo(uplo),
                    diag=_diag(diag))
        B = _ingest(b, dt, A.grid, nb=A.nb)
        return _out(_trsm(_side(side), alpha, _apply_op(A, transa), B))
    return _shim(pre, "trsm", trsm)


_mod = sys.modules[__name__]
for _pre in "sdcz":
    for _make in (_make_gesv, _make_posv, _make_potrf, _make_potrs,
                  _make_potri, _make_getrf, _make_getrs, _make_getri,
                  _make_geqrf, _make_gels, _make_gemm, _make_gesvd,
                  _make_lange, _make_lantr, _make_trmm, _make_trsm,
                  _make_gesv_mixed):
        _f = _make(_pre)
        setattr(_mod, _f.__name__, _f)
    for _make, _name in ((_make_lanhe, "lansy"), (_make_hemm, "symm"),
                         (_make_herk, "syrk"), (_make_her2k, "syr2k")):
        _f = _make(_pre, _name)
        setattr(_mod, _f.__name__, _f)
for _pre in "sd":
    setattr(_mod, f"slate_{_pre}syev", _make_syev(_pre, "syev"))
for _pre in "cz":
    for _make, _name in ((_make_syev, "heev"), (_make_hemm, "hemm"),
                         (_make_herk, "herk"), (_make_her2k, "her2k"),
                         (_make_lanhe, "lanhe")):
        _f = _make(_pre, _name)
        setattr(_mod, _f.__name__, _f)

__all__ = [n for n in dir(_mod) if n.startswith("slate_")]
