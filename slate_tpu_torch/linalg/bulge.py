"""Stage-2 support of the two-stage eig/SVD: band gathers from the tile
storage, the packed-reflector back-transform, and the bidiagonal SVD
(reference src/hb2st.cc, src/tb2bd.cc, src/unmtr_hb2st.cc,
src/bdsqr.cc; counterpart of ``slate_tpu/linalg/bulge.py``).

* :func:`gather_band_lower` / :func:`gather_band_upper` read only the
  2·nt band tiles on the matrix's device, from their owners on a p×q
  grid (``comm.gather_tiles``) — no dense matrix, no host round trip.
* :func:`apply_bulge_reflectors` applies a packed (sweep, chase)
  reflector family (``internal/band_bulge.py`` format, real or complex)
  to the rows of a tensor. The spans within one sweep are disjoint, so a Python loop
  walks the sweeps and each applies its T reflectors as one batched
  product.
* :func:`bdsqr` is the bidiagonal SVD on the host through the
  Golub–Kahan tridiagonal (scipy), as the JAX package does it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..internal import comm
from ..internal.precision import full_f32_matmul


def _band_tiles(A, super_diag: bool):
    """The diagonal tiles and the first sub- or super-diagonal tiles,
    fetched from their owners on any grid (2·nt tiles, never the dense
    matrix)."""
    nt = min(A.mt, A.nt)
    k = torch.arange(nt, device=A.data.device)
    Td = comm.gather_tiles(A.data, k, k)[0, 0]
    if super_diag:
        Ts = comm.gather_tiles(A.data, k[:-1], k[:-1] + 1)[0, 0]
    else:
        Ts = comm.gather_tiles(A.data, k[:-1] + 1, k[:-1])[0, 0]
    return Td, Ts


def _gather_band(A, n: int, super_diag: bool) -> torch.Tensor:
    nb = A.nb
    Td, Ts = _band_tiles(A, super_diag)
    dev = Td.device
    d = torch.arange(nb + 1, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    k, c = j // nb, j % nb
    sel = j + d < n
    same = c + d < nb
    ab = Td.new_zeros((nb + 1, n))
    kk, cc, dd = (x.expand(nb + 1, n) for x in (k, c, d))
    m = sel & same
    # in-tile (row, col) of A[j+d, j] (lower) or A[j, j+d] (upper)
    r1, c1 = ((cc, cc + dd) if super_diag else (cc + dd, cc))
    ab[m] = Td[kk[m], r1[m], c1[m]]
    m = sel & ~same
    if bool(m.any()):
        r2, c2 = ((cc, cc + dd - nb) if super_diag else (cc + dd - nb, cc))
        ab[m] = Ts[kk[m], r2[m], c2[m]]
    return ab


def gather_band_lower(A) -> torch.Tensor:
    """Compact lower band ``ab[d, j] = A[j+d, j]`` (d = 0..nb) of a
    he2hb output, from its 2·nt band tiles, on its device; a complex
    (Hermitian) band's diagonal keeps its real part."""
    ab = _gather_band(A, A.n, super_diag=False)
    if ab.is_complex():
        ab[0] = ab[0].real
    return ab


def gather_band_upper(A) -> torch.Tensor:
    """Compact upper band ``ub[d, j] = A[j, j+d]`` (d = 0..nb) of a
    ge2tb output, from its 2·nt band tiles, on its device."""
    return _gather_band(A, min(A.m, A.n), super_diag=True)


def apply_bulge_reflectors(V, tau, Z: torch.Tensor, band: int,
                           forward: bool = False,
                           conj_tau: bool = True) -> torch.Tensor:
    """Apply the packed reflector product to the rows of Z [n, m]; a new
    tensor (the JAX package's ``apply_bulge_reflectors``). forward=False
    with ``conj_tau`` (the default) gives H₁ᴴ·…·H_Kᴴ·Z, the band →
    tri/bidiagonal back-transform of hb2st's Q and tb2bd's U₂ and V₂;
    forward=True H_K·…·H₁·Z, and without ``conj_tau`` each H in place of
    Hᴴ (H = I − τ·v·vᴴ, so Hᴴ takes conj(τ)). The port's callers all
    pass ``conj_tau = not forward``; the parameter keeps the JAX
    signature, and its tests hold the other two combinations to the
    JAX package's. Each reflector applies as
    w = vᴴ·Z, Z −= τ·v·w. Z is padded to the sweeps' reach so every sweep
    is one [T, band, m] window; the padding rows stay zero because the
    packs are zero past each reflector's length. Complex64 products run
    under the FP32 pin."""
    S, T = tau.shape
    n, m = Z.shape
    if tau.numel() == 0:
        return Z.clone()
    Zp = Z.new_zeros((S + T * band + 1, m))
    Zp[:n] = Z
    V = V.to(Z.dtype)
    tau = tau.to(Z.dtype)
    Vc = V.conj()
    if conj_tau:
        tau = tau.conj()
    with full_f32_matmul():
        for i in range(S):
            s = i if forward else S - 1 - i
            Zw = Zp[s + 1:s + 1 + T * band].view(T, band, m)   # a view of Zp
            w = torch.bmm(Vc[s].unsqueeze(1), Zw)               # [T, 1, m]
            Zw.sub_((tau[s][:, None] * V[s]).unsqueeze(2) * w)
    return Zp[:n]


def bdsqr(d, e, want_uv: bool = False):
    """SVD of the real upper bidiagonal B = diag(d) + superdiag(e) on the
    host (reference src/bdsqr.cc slot), through the eigenproblem of the
    2n×2n Golub–Kahan tridiagonal (LAPACK ?bdsvdx's method; scipy has no
    bdsqr). ``d``, ``e`` are tensors or arrays; the results are float64
    numpy arrays: σ descending, and with ``want_uv`` (σ, U, Vᵀ) with
    B = U·diag(σ)·Vᵀ. A zero σ's vector halves are completed to an
    orthonormal basis of the null spaces, so rank deficiency keeps both
    B = U·Σ·Vᵀ and orthogonality."""
    from scipy.linalg import eigh_tridiagonal, eigvalsh_tridiagonal
    d = np.asarray(torch.as_tensor(d).cpu(), np.float64)
    e = np.asarray(torch.as_tensor(e).cpu(), np.float64)
    n = d.shape[0]
    if n == 0:
        z = np.zeros((0, 0))
        return (np.zeros(0), z, z) if want_uv else np.zeros(0)
    if n == 1:
        s = np.abs(d[:1])
        if not want_uv:
            return s
        return s, np.ones((1, 1)) * (1.0 if d[0] >= 0 else -1.0), np.ones((1, 1))
    # TGK: zero diagonal, off-diagonal (d0, e0, d1, e1, …, d_{n-1}); the
    # eigenvector of +σ interleaves (v0, u0, v1, u1, …)/√2
    off = np.zeros(2 * n - 1)
    off[0::2] = d
    off[1::2] = e
    diag = np.zeros(2 * n)
    if not want_uv:
        w = eigvalsh_tridiagonal(diag, off)
        return np.maximum(w[n:], 0.0)[::-1].copy()
    # all 2n eigenpairs by divide and conquer (stevd), then the upper
    # half: ~15× faster than the upper half alone by bisection and
    # inverse iteration (stebz + stein, the JAX package's select="i"),
    # whose reorthogonalisation of clustered pairs dominates at n ≥ 2048
    w, Zt = eigh_tridiagonal(diag, off, lapack_driver="stevd")
    w, Zt = w[n:], Zt[:, n:]
    order = np.argsort(w)[::-1]
    s = np.maximum(w[order], 0.0)
    Zt = Zt[:, order]
    Vm = np.ascontiguousarray(Zt[0::2, :]) * np.sqrt(2.0)
    U = np.ascontiguousarray(Zt[1::2, :]) * np.sqrt(2.0)
    for M in (U, Vm):
        norms = np.linalg.norm(M, axis=0)
        good = norms > 0.5
        M[:, good] /= norms[good]
        if not good.all():
            bad = np.where(~good)[0]
            full = np.concatenate([M[:, good], np.eye(n)], axis=1)
            Qf, _ = np.linalg.qr(full)
            g = int(good.sum())
            M[:, bad] = Qf[:, g:g + bad.size]
    return s, U, Vm.T.copy()
