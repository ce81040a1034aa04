"""LAPACK char-flag parsing for the compatibility surface (counterpart of
``slate_tpu/compat_flags.py``; the reference's char→enum switch in
lapack_api/lapack_slate.hh).
"""

from __future__ import annotations

import numpy as np

from .types import Diag, Norm, Op, Side, Uplo


def uplo_from_char(u) -> Uplo:
    return Uplo.Lower if str(u).lower().startswith("l") else Uplo.Upper


def side_from_char(s) -> Side:
    return Side.Left if str(s).lower().startswith("l") else Side.Right


def diag_from_char(d) -> Diag:
    return Diag.Unit if str(d).lower().startswith("u") else Diag.NonUnit


def norm_from_char(k) -> Norm:
    k = str(k).lower()[0]
    return {"m": Norm.Max, "1": Norm.One, "o": Norm.One,
            "i": Norm.Inf, "f": Norm.Fro, "e": Norm.Fro}[k]


def op_from_char(trans) -> Op:
    t = str(trans).lower()[0]
    return {"n": Op.NoTrans, "t": Op.Trans, "c": Op.ConjTrans}[t]


def apply_op_char(M, trans):
    """Wrap a matrix in the transpose view named by a LAPACK trans char
    ('N'/'T'/'C')."""
    from .matrix import conj_transpose, transpose
    t = str(trans).lower()[0]
    return {"n": lambda x: x, "t": transpose,
            "c": conj_transpose}[t](M)


def mirror_triangle_np(full: np.ndarray, uplo: Uplo) -> np.ndarray:
    """Mirror the significant triangle of a dense (numpy) Hermitian result
    into a full matrix — shared by the potri shims."""
    cplx = np.iscomplexobj(full)
    if uplo == Uplo.Lower:
        keep, half = np.tril(full), np.tril(full, -1)
    else:
        keep, half = np.triu(full), np.triu(full, 1)
    return keep + (np.conj(half.T) if cplx else half.T)
