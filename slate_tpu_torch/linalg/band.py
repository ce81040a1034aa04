"""The band LU and band Cholesky on packed storage (reference
src/gbtrf.cc, src/gbtrs.cc, src/pbtrf.cc, src/pbtrs.cc; counterpart of
the factorization half of ``slate_tpu/linalg/band.py``).

The storage, ``ab[ku + i - j, j] = A[i, j]``, its windows and the
fixed-band products and solves are in ``internal/band_packed.py``. The
band LU follows dgbtrf's storage contract: U (with its fill-in, upper
bandwidth kl + ku) stays in the packed array; each panel's unit-lower
multipliers are kept, with only that panel's row interchanges applied,
in a dense per-panel store ``lpan``, and the solve applies each panel's
permutation on the fly — LAPACK's gbtrs at block granularity.

The JAX package runs each factorization as one jitted loop over block
columns, moving a static-shape window out of and back into the packed
array by masked gathers. The port loops in Python over the same windows;
the gather and scatter indices of a window depend only on its shape, so
they are built once per call, and each step moves its window with one
gather and one scatter. The trailing update of each panel, whose
contraction is the band block (below 128 for 2kl + ku < 128), goes
through ``tile_kernels.tile_gemm`` and so to the rank-k tail kernel K11.

The band Cholesky (``band.py:136-233``) takes the same windows over the
lower packed layout: each diagonal block goes through
``tile_kernels.tile_potrf`` (K1), its L21 through
``tile_trsm_right_lower_t`` (K2) and the forward solve of pbtrs through
``tile_trsm_left_lower`` (K3), where the JAX package calls XLA's
``cholesky`` and ``triangular_solve``. pbtrs gathers all its windows at
once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..internal.band_packed import _get, _get_all, _put, _window, band_unpack
from ..internal.precision import full_f32_matmul
from ..internal.tile_kernels import (_factor_dtype, hermitian_tile,
                                     tile_gemm, tile_potrf,
                                     tile_trsm_left_lower,
                                     tile_trsm_right_lower_t)
from ..matrix import cdiv
from ..robust.guards import finite_guard
from ..types import Op, Uplo


class BandCholFactor(NamedTuple):
    """Packed band Cholesky factor: ``ab[d, j] = L[j + d, j]``,
    d = 0 … kd, over at least n columns (``band.py:60-75``)."""
    ab: torch.Tensor
    n: int
    kd: int
    uplo: Uplo = Uplo.Lower

    def to_dense(self) -> torch.Tensor:
        """The dense lower factor L [n, n]."""
        return band_unpack(self.ab, self.n, self.n, self.kd, 0)


class BandLUFactor(NamedTuple):
    """Band LU factor. ``ab`` is the packed working array, U in its
    rows 0 … kl + ku (bandwidths (0, kl + ku), U's fill-in band);
    ``lpan [kt, nb + kl, nb]`` each panel's unit-lower multipliers in
    panel-permuted order; ``piv [kt, nb]`` int32 0-based global pivot
    rows (row k·nb + j swapped with ``piv[k, j]``)."""
    ab: torch.Tensor
    lpan: torch.Tensor
    piv: torch.Tensor
    m: int
    n: int
    kl: int
    ku: int
    nb: int

    def to_dense(self) -> torch.Tensor:
        """Dense U (the L factor is per-panel permuted; use ``lpan``)."""
        return band_unpack(self.ab, self.m, self.n, 0, self.kl + self.ku)


# ---------------------------------------------------------------------------
# band Cholesky (pbtrf / pbtrs) on packed lower storage
# ---------------------------------------------------------------------------

def pbtrf_packed(ab: torch.Tensor, n: int, kd: int, nb: int):
    """Factor an HPD band A (lower packed, ``ab[kd + 1, ≥ nt·nb + nb +
    kd]``) into L·Lᴴ in place (``band.py:160-193``). Returns
    ``(ab, info)``: info the 1-based index of the first non-SPD block
    column, 0 on success, a 0-dim int32 tensor on ab's device.

    Per block column: the dense [nb + kd, nb + kd] window, the diagonal
    block mirrored from its lower half and factored by ``tile_potrf``
    (K1), L21 = A21·L11⁻ᴴ by ``tile_trsm_right_lower_t`` (K2), the
    trailing band block updated by one product, the window's lower band
    written back. A failed block is reported by ``finite_guard`` and
    zero-filled, so the loop runs to its end."""
    nt = cdiv(n, nb)
    h = nb + kd
    dev = ab.device
    fd = _factor_dtype(ab.dtype)
    cplx = ab.dtype.is_complex
    win = _window(kd + 1, ab.shape[1], h, h, 0, dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for k in range(nt):
            c0 = k * nb
            D = _get(ab, win, c0)                    # lower band valid only
            akk = hermitian_tile(D[:nb, :nb])
            lkk, info = finite_guard(tile_potrf(akk), info, k + 1, diag=True,
                                     cplx=cplx)
            D[:nb, :nb] = lkk.tril()
            if kd:
                l21 = tile_trsm_right_lower_t(lkk.to(fd), D[nb:, :nb].to(fd))
                l21, info = finite_guard(l21.to(ab.dtype), info, k + 1,
                                         cplx=cplx)
                D[nb:, :nb] = l21
                D[nb:, nb:] -= l21 @ l21.mH
            _put(ab, win, c0, D)
    return ab, info


def pbtrs_packed(abL: torch.Tensor, b: torch.Tensor, n: int, kd: int,
                 nb: int) -> torch.Tensor:
    """Solve L·Lᴴ·x = b from :func:`pbtrf_packed`'s factor
    (``band.py:196-233``). ``b`` is dense [≥ nt·nb + kd, nrhs] (rows ≥ n
    zero); a new tensor comes back. The forward solve of each diagonal
    block goes through ``tile_trsm_left_lower`` (K3), the backward one
    with L11ᴴ to ``torch.linalg``."""
    nt = cdiv(n, nb)
    h = nb + kd
    b = b.clone()
    blocks = _get_all(abL, _window(kd + 1, abL.shape[1], h, nb, 0,
                                   abL.device), nb, nt)
    lkk, l21 = blocks[:, :nb].tril(), blocks[:, nb:]
    with full_f32_matmul():
        for k in range(nt):
            c0 = k * nb
            y1 = tile_trsm_left_lower(lkk[k], b[c0:c0 + nb])
            b[c0:c0 + nb] = y1
            b[c0 + nb:c0 + h] -= l21[k] @ y1
        for k in reversed(range(nt)):
            c0 = k * nb
            rhs = b[c0:c0 + nb] - l21[k].mH @ b[c0 + nb:c0 + h]
            b[c0:c0 + nb] = tile_trsm_left_lower(lkk[k], rhs, trans=True)
    return b


# ---------------------------------------------------------------------------
# band LU (gbtrf) on packed working storage
# ---------------------------------------------------------------------------

def gbtrf_packed(ab: torch.Tensor, m: int, n: int, kl: int, ku: int,
                 nb: int, tier: str = "bf16_6x"):
    """Pivoted band LU on packed working storage
    ``ab[2kl + ku + 1, ≥ nt·nb + nb + kl + kl + ku]`` (band offsets
    (kl, kl + ku), the fill-in rows zero), updated in place. Returns
    ``(ab, lpan, piv, info)`` as :class:`BandLUFactor` holds them;
    ``info`` the number of exactly-zero pivots (``band.py:239-287``).

    Per panel: the dense [nb + kl, nb + kl + kl + ku] window, a pivoted
    LU of its first nb columns (``torch.linalg.lu_factor_ex``, the
    counterpart of ``lax.linalg.lu``), the row permutation of the rest,
    the U12 solve, and the trailing update through ``tile_gemm``."""
    kuf = kl + ku
    ldab = kl + kuf + 1
    nt = cdiv(min(m, n), nb)
    hr, hc = nb + kl, nb + kl + kuf
    dev = ab.device
    fd = _factor_dtype(ab.dtype)
    win = _window(ldab, ab.shape[1], hr, hc, kuf, dev)
    eye = torch.eye(nb, dtype=ab.dtype, device=dev)
    lpans = ab.new_zeros((nt, hr, nb))
    pivs = torch.zeros((nt, nb), dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for k in range(nt):
            c0 = k * nb
            D = _get(ab, win, c0)
            lu, ipiv, _ = torch.linalg.lu_factor_ex(D[:, :nb].to(fd))
            lu = lu.to(ab.dtype)
            P, _, _ = torch.lu_unpack(lu, ipiv, unpack_data=False)
            # LU = A[perm]
            perm = (P.real if P.is_complex() else P).argmax(dim=0)
            info += (torch.diagonal(lu[:nb]) == 0).sum().int()
            right = D[:, nb:][perm]
            u12 = torch.linalg.solve_triangular(
                lu[:nb].tril(-1) + eye, right[:nb], upper=False,
                unitriangular=True)
            Dn = torch.zeros_like(D)
            Dn[:nb, :nb] = lu[:nb].triu()
            Dn[:nb, nb:] = u12
            if kl:
                Dn[nb:, nb:] = tile_gemm(-1.0, lu[nb:], u12, 1.0,
                                         right[nb:], tier)
            lpans[k] = lu.tril(-1)
            _put(ab, win, c0, Dn)
            pivs[k] = ipiv - 1 + c0
    return ab, lpans, pivs, info


def _panel_perms(piv: torch.Tensor, nb: int, hr: int) -> torch.Tensor:
    """Each panel's cumulative permutation of its hr window rows, encoded
    by its sequential swaps (row j ↔ piv[k, j] − k·nb, clipped to the
    window, ``band.py:290-301``): ``[kt, hr]`` int64 on piv's device.
    Resolved on the host once per solve, one O(hr) pass per panel."""
    host = piv.cpu().numpy().astype(np.int64)
    kt = host.shape[0]
    loc = np.clip(host - (np.arange(kt) * nb)[:, None], 0, hr - 1)
    perms = np.stack([runtime.resolve_pivots(loc[k], hr)
                      for k in range(kt)]) if kt else np.zeros((0, hr))
    return torch.from_numpy(perms.astype(np.int64)).to(piv.device)


def gbtrs_packed(ab: torch.Tensor, lpan: torch.Tensor, piv: torch.Tensor,
                 b: torch.Tensor, m: int, n: int, kl: int, ku: int, nb: int,
                 trans: Op = Op.NoTrans) -> torch.Tensor:
    """Solve op(A)·x = b from :func:`gbtrf_packed` factors
    (``band.py:304-389``). ``b`` is dense [≥ nt·nb + kl + kl + ku, nrhs],
    rows ≥ n zero; a new tensor comes back. L's panel permutations are
    applied on the fly. ConjTrans conjugates the factors of Trans
    (``band.py:318-319``)."""
    kuf = kl + ku
    ldab = kl + kuf + 1
    nt = cdiv(min(m, n), nb)
    hr, hu = nb + kl, nb + kuf
    dev = ab.device
    b = b.clone()
    win = _window(ldab, ab.shape[1], nb, hu, kuf, dev)
    eye = torch.eye(nb, dtype=ab.dtype, device=dev)
    perms = _panel_perms(piv, nb, hr)
    # op(X) of the transposed solves: Xᵀ, or Xᴴ for ConjTrans
    cj = torch.conj if trans == Op.ConjTrans else (lambda x: x)

    def u_block(k):
        D = _get(ab, win, k * nb)
        return D[:, :nb].triu(), D[:, nb:]           # U11, U12

    with full_f32_matmul():
        if trans == Op.NoTrans:
            for k in range(nt):                      # P·L forward
                c0 = k * nb
                l11, l21 = lpan[k][:nb] + eye, lpan[k][nb:]
                W = b[c0:c0 + hr][perms[k]]
                y1 = torch.linalg.solve_triangular(l11, W[:nb], upper=False,
                                                   unitriangular=True)
                W[nb:] -= l21 @ y1
                W[:nb] = y1
                b[c0:c0 + hr] = W
            for k in reversed(range(nt)):            # U backward
                c0 = k * nb
                u11, u12 = u_block(k)
                rhs = b[c0:c0 + nb] - u12 @ b[c0 + nb:c0 + hu]
                b[c0:c0 + nb] = torch.linalg.solve_triangular(
                    u11, rhs, upper=True)
            return b
        for k in range(nt):                          # op(U) forward
            c0 = k * nb
            u11, u12 = u_block(k)
            x1 = torch.linalg.solve_triangular(cj(u11).mT, b[c0:c0 + nb],
                                               upper=False)
            b[c0 + nb:c0 + hu] -= cj(u12).mT @ x1
            b[c0:c0 + nb] = x1
        for k in reversed(range(nt)):                # op(L) backward, P⁻¹
            c0 = k * nb
            l11, l21 = lpan[k][:nb] + eye, lpan[k][nb:]
            W = b[c0:c0 + hr].clone()
            rhs = W[:nb] - cj(l21).mT @ W[nb:]
            W[:nb] = torch.linalg.solve_triangular(
                cj(l11).mT, rhs, upper=True, unitriangular=True)
            b[c0:c0 + hr][perms[k]] = W
        return b
