"""Carry a matrix, LU pivots and QR T factors across from the JAX package
and back.

A matrix of either package is its storage ``data[p, q, mtl, ntl, nb, nb]``
plus plain fields, laid out the same way in both. These functions take
and give the fields as a numpy array and plain strings, so this package
never touches a JAX object; the storage is kept bit for bit. Pivots
cross as a numpy int32 ``[kt, nb]`` array, LAPACK ipiv or, wrapped in a
``PivotOrder`` on either side, an elimination order. The T factors of
``geqrf``/``gelqf``/``he2hb``/``ge2tb`` cross as a numpy ``[kt, nb, nb]``
array. The two-stage eig/SVD's compact bands (``ab``/``ub``
``[band + 1, n]``) and packed bulge reflectors (``V [S, T, band]``,
``tau [S, T]``) cross as numpy arrays too, real or complex, with tb2bd's
column-0 phase as a numpy scalar, so either package's back-transform can
run on the other's stage-1 and stage-2 output. A band
LU factor crosses as a dict of numpy arrays and ints, and the hetrf
factors ``(L, T band LU factor, piv)`` as a dict of the three, so either
package's ``gbtrs``/``hetrs`` can run on the other's factors, and a band
Cholesky factor as a dict of its packed ``ab`` and its ints, for either
package's ``pbtrs``.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import slate_error_if
from .grid import Grid
from .linalg.band import BandCholFactor, BandLUFactor
from .linalg.getrf import PivotOrder
from .matrix import (BandMatrix, BaseTiledMatrix, HermitianBandMatrix,
                     HermitianMatrix, Matrix, SymmetricMatrix,
                     TrapezoidMatrix, TriangularBandMatrix, TriangularMatrix)
from .types import Diag, Op, Uplo

_KINDS = {cls.__name__: cls
          for cls in (Matrix, HermitianMatrix, TriangularMatrix, BandMatrix,
                      TrapezoidMatrix, SymmetricMatrix, TriangularBandMatrix,
                      HermitianBandMatrix)}


def from_reference(data: np.ndarray, *, kind: str, m: int, n: int, nb: int,
                   op: str = "NoTrans", uplo: str = "General",
                   diag: str = "NonUnit", kl: int = 0, ku: int = 0,
                   device=None) -> BaseTiledMatrix:
    """Build the port's matrix from a JAX matrix's fields: ``data`` is
    ``np.asarray(A.data)``, ``kind`` its class name, ``op``/``uplo``/
    ``diag`` the enum member names (``A.op.name`` …), ``kl``/``ku`` a
    band's widths. ``device`` is as for :class:`Grid`."""
    slate_error_if(kind not in _KINDS, f"from_reference: unknown kind {kind!r}"
                   f"; expected one of {sorted(_KINDS)}")
    data = np.asarray(data)
    slate_error_if(data.ndim != 6 or data.shape[4:] != (nb, nb),
                   f"from_reference: storage must be [p, q, mtl, ntl, nb, "
                   f"nb], got {data.shape}")
    grid = Grid(data.shape[0], data.shape[1], device=device)
    t = torch.from_numpy(np.array(data, order="C")).to(grid.device)
    return _KINDS[kind](data=t, m=m, n=n, nb=nb, grid=grid, op=Op[op],
                        uplo=Uplo[uplo], diag=Diag[diag], kl=kl, ku=ku)


def to_reference(M: BaseTiledMatrix) -> dict:
    """The fields of :func:`from_reference` for ``M``: ``data`` as a numpy
    array on the host, the rest as plain ints and strings."""
    return {"data": M.data.detach().cpu().numpy(), "kind": type(M).__name__,
            "m": M.m, "n": M.n, "nb": M.nb, "op": M.op.name,
            "uplo": M.uplo.name, "diag": M.diag.name, "kl": M.kl,
            "ku": M.ku}


def pivots_from_reference(piv, *, order: bool = False, device=None):
    """The port's pivots from a JAX ``getrf``'s ``np.asarray(piv)`` (or
    ``np.asarray(PivotOrder.order)`` with ``order=True``, which then
    comes back wrapped in the port's ``PivotOrder``): an int32 ``[kt, nb]``
    tensor on ``device`` (as for :class:`Grid`)."""
    piv = np.asarray(piv)
    slate_error_if(piv.ndim != 2, f"pivots must be [kt, nb], got {piv.shape}")
    t = torch.from_numpy(piv.astype(np.int32)).to(Grid(1, 1,
                                                       device=device).device)
    return PivotOrder(t) if order else t


def pivots_to_reference(piv) -> np.ndarray:
    """The numpy int32 ``[kt, nb]`` array of the port's pivots (ipiv or a
    ``PivotOrder``), for ``jnp.asarray`` or the JAX ``PivotOrder``."""
    t = piv.order if isinstance(piv, PivotOrder) else piv
    return t.detach().cpu().numpy().astype(np.int32)


def t_factors_from_reference(T, *, device=None) -> torch.Tensor:
    """The port's T factors from a JAX ``geqrf``'s ``np.asarray(T)``: a
    ``[kt, nb, nb]`` tensor on ``device`` (as for :class:`Grid`)."""
    T = np.asarray(T)
    slate_error_if(T.ndim != 3 or T.shape[1] != T.shape[2],
                   f"T factors must be [kt, nb, nb], got {T.shape}")
    return torch.from_numpy(np.array(T, order="C")).to(
        Grid(1, 1, device=device).device)


def t_factors_to_reference(T: torch.Tensor) -> np.ndarray:
    """The numpy ``[kt, nb, nb]`` array of the port's T factors, for
    ``jnp.asarray``."""
    return T.detach().cpu().numpy()


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C")).to(
        Grid(1, 1, device=device).device)


def band_from_reference(ab, *, device=None) -> torch.Tensor:
    """The port's compact band from a JAX ``he2hb_gather`` or
    ``ge2tb_gather`` numpy array ``[band + 1, n]``."""
    ab = np.asarray(ab)
    slate_error_if(ab.ndim != 2, f"a band must be [band + 1, n], got "
                   f"{ab.shape}")
    return _tensor(ab, device)


def band_to_reference(ab: torch.Tensor) -> np.ndarray:
    """The numpy ``[band + 1, n]`` array of the port's compact band."""
    return ab.detach().cpu().numpy()


def reflectors_from_reference(V, tau, *, device=None):
    """The port's packed bulge reflectors ``(V [S, T, band], tau [S, T])``
    from a JAX ``hb2st``/``tb2bd`` pack (numpy or device arrays through
    ``np.asarray``)."""
    V, tau = np.asarray(V), np.asarray(tau)
    slate_error_if(V.ndim != 3 or tau.shape != V.shape[:2],
                   f"packed reflectors must be V [S, T, band] and tau "
                   f"[S, T], got {V.shape} and {tau.shape}")
    return _tensor(V, device), _tensor(tau, device)


def reflectors_to_reference(V: torch.Tensor, tau: torch.Tensor):
    """The numpy ``(V, tau)`` of the port's packed bulge reflectors."""
    return V.detach().cpu().numpy(), tau.detach().cpu().numpy()


def phase_from_reference(phase0, *, device=None) -> torch.Tensor:
    """The port's tb2bd column-0 phase (a 0-dim tensor of its dtype) from
    the JAX ``tb2bd``'s ``phase0`` (a numpy scalar)."""
    return _tensor(np.asarray(phase0).reshape(()), device)


def phase_to_reference(phase0: torch.Tensor):
    """The numpy scalar of the port's tb2bd column-0 phase."""
    return phase0.detach().cpu().numpy()[()]


_BAND_INTS = ("m", "n", "kl", "ku", "nb")


def band_lu_from_reference(ab, lpan, piv, *, m: int, n: int, kl: int,
                           ku: int, nb: int, device=None) -> BandLUFactor:
    """The port's band LU factor from a JAX ``BandLUFactor``'s fields:
    ``np.asarray`` of its ``ab``, ``lpan`` and ``piv`` and its ints."""
    ab, lpan, piv = np.asarray(ab), np.asarray(lpan), np.asarray(piv)
    slate_error_if(ab.ndim != 2 or lpan.ndim != 3 or piv.ndim != 2,
                   f"a band LU factor is ab [ldab, ncols], lpan [kt, hr, nb] "
                   f"and piv [kt, nb], got {ab.shape}, {lpan.shape}, "
                   f"{piv.shape}")
    return BandLUFactor(_tensor(ab, device), _tensor(lpan, device),
                        _tensor(piv.astype(np.int32), device), m, n, kl, ku,
                        nb)


def band_lu_to_reference(F: BandLUFactor) -> dict:
    """The fields of :func:`band_lu_from_reference` for ``F``, as numpy
    arrays and ints, for the JAX ``BandLUFactor(ab, lpan, piv, m, n, kl,
    ku, nb)``."""
    return {"ab": F.ab.detach().cpu().numpy(),
            "lpan": F.lpan.detach().cpu().numpy(),
            "piv": F.piv.detach().cpu().numpy().astype(np.int32),
            **{k: getattr(F, k) for k in _BAND_INTS}}


def band_chol_from_reference(ab, *, n: int, kd: int, uplo: str = "Lower",
                             device=None) -> BandCholFactor:
    """The port's band Cholesky factor from a JAX ``BandCholFactor``'s
    fields: ``np.asarray`` of its packed ``ab [kd + 1, ncols]``, its
    ``n``, ``kd`` and the name of its ``uplo``."""
    ab = np.asarray(ab)
    slate_error_if(ab.ndim != 2 or ab.shape[0] != kd + 1 or ab.shape[1] < n,
                   f"a band Cholesky factor is ab [kd + 1, >= n] = "
                   f"[{kd + 1}, >= {n}], got {ab.shape}")
    return BandCholFactor(_tensor(ab, device), n, kd, Uplo[uplo])


def band_chol_to_reference(F: BandCholFactor) -> dict:
    """The fields of :func:`band_chol_from_reference` for ``F``, for the
    JAX ``BandCholFactor(ab, n, kd, uplo)``."""
    return {"ab": F.ab.detach().cpu().numpy(), "n": F.n, "kd": F.kd,
            "uplo": F.uplo.name}


def hetrf_from_reference(L: dict, T: dict, piv, *, device=None):
    """The port's hetrf factors ``(L, T, piv)`` from the JAX ones: ``L``
    the :func:`to_reference`-style fields of the JAX L, ``T`` those of
    :func:`band_lu_from_reference` of its band factor, ``piv`` its
    ``np.asarray(piv)``."""
    return (from_reference(**L, device=device),
            band_lu_from_reference(**T, device=device),
            pivots_from_reference(piv, device=device))


def hetrf_to_reference(factors) -> dict:
    """``{"L": …, "T": …, "piv": …}``: the JAX-side fields of the port's
    hetrf factors (:func:`to_reference`, :func:`band_lu_to_reference`,
    :func:`pivots_to_reference`)."""
    L, T, piv = factors
    return {"L": to_reference(L), "T": band_lu_to_reference(T),
            "piv": pivots_to_reference(piv)}
