"""Two-stage symmetric eigensolver: he2hb (full → band),
its back-transform, the band gather, the hb2st dispatch and the whole
pipeline (reference src/he2hb.cc, src/unmtr_he2hb.cc, src/hb2st.cc,
src/unmtr_hb2st.cc, src/heev.cc:104-172; counterpart of
``slate_tpu/linalg/he2hb.py``).

On a 1×1 grid the JAX package's ``shard_map`` loop collapses to slices
of one dense copy of the matrix, updated in place. Per block column k:

1. the panel below the diagonal block is factored by ``torch.geqrf``
   (``panel_qr_factor``, ``extract_v``, as in the JAX package, where it
   is XLA's ``geqrf``); its T comes from the reflectors' Gram matrix by
   ``geqrf._blocked_T`` (a few batched products) where the JAX package
   runs the ``larft`` column recurrence — the same T, without an
   nb-long loop of small launches per panel;
2. Y = A₂₂·V with A₂₂ read from its lower triangle only (the strict
   lower part conjugated for its mirror);
3. X = Y·T, W = X − ½·V·(Tᴴ·(Vᴴ·X));
4. A₂₂ ← A₂₂ − W·Vᴴ − V·Wᴴ.

Afterwards the storage holds the band with the V blocks below it, plus
the [kt, nb, nb] T stack.

On a p×q grid of virtual ranks he2hb and unmtr_he2hb are the JAX
package's SPMD loops (``he2hb.py:70-167``, ``:188-232``) over the
rank-stacked tiles, on the window of slots from ((k+1) // p,
(k+1) // q): the gathered panel factored once and written back to its
owner column; Y from the lower triangle alone, each rank's rows of
A₂₂·V summed along the grid rows' ``psum_cols`` and the conjugated
strict part's columns along ``psum_rows``, both gathered with
``allgather_cyclic``; the rank-2 update as one product over the ranks.
The band gather fetches the 2·nt band tiles from their owners, and the
rest of the pipeline runs as on one rank. Real and complex dtypes; the tridiagonal stage
runs in the real dtype, the eigenvalues come out in it, and a complex64
product runs under the FP32 pin.
"""

from __future__ import annotations

import time

import torch

from ..errors import SlateError, slate_error_if
from ..internal import comm, kernels, masks
from ..internal.band_wave import preferred_eig_band
from ..internal.precision import full_f32_matmul, resolve_tier, tier_mm
from ..internal.tile_kernels import extract_v, panel_qr_factor
from ..matrix import (HermitianMatrix, Matrix, bc_from_tiles, cdiv,
                      dense_to_tiles, tiles_to_dense)
from ..ops.blas import _outer_pq
from ..types import MethodEig, Op, Option, Uplo, get_option
from .bulge import apply_bulge_reflectors, gather_band_lower
from .geqrf import (_gather_col_panel, _put_col_panel, _qr_panel_pq,
                    _reflect_left_pq, _slots, panel_t)


def he2hb(A: HermitianMatrix, opts=None):
    """Reduce Hermitian A (lower storage) to band form A = Q·B·Qᴴ, B of
    bandwidth nb. Returns ``(Aband, T)``: Aband's storage holds the band
    and the V blocks below it (the reference's in-place layout), T is
    [max(nt − 1, 1), nb, nb]. A is not modified."""
    slate_error_if(A.m != A.n, "he2hb needs square")
    slate_error_if(A.uplo != Uplo.Lower, "he2hb v1: lower storage")
    tier = resolve_tier(opts)
    if A.grid.size > 1:
        data, Ts = _he2hb_pq(A, tier)
        return HermitianMatrix(data=data, m=A.m, n=A.n, nb=A.nb,
                               grid=A.grid, uplo=Uplo.Lower), Ts
    nb, n = A.nb, A.n
    M = A.mtl * nb
    kt = max(A.nt - 1, 0)
    a = tiles_to_dense(A.data[0, 0], M, A.ntl * nb)     # a new tensor, in place
    Ts = a.new_zeros((max(kt, 1), nb, nb))
    for k in range(kt):
        start = (k + 1) * nb
        pan, taus = panel_qr_factor(a[:, k * nb:start], start, n)
        a[:, k * nb:start] = pan
        V = extract_v(pan, start, n)[start:n]
        Ts[k] = T = panel_t(V, taus)
        A22 = a[start:n, start:n]                        # a view of a
        Y = (tier_mm(torch.tril(A22), V, tier)
             + tier_mm(torch.tril(A22, -1).mH, V, tier))
        with full_f32_matmul():
            X = Y @ T
            W = X - 0.5 * (V @ (T.mH @ (V.mH @ X)))
        A22.sub_(tier_mm(W, V.mH, tier) + tier_mm(V, W.mH, tier))
    data = bc_from_tiles(dense_to_tiles(a, nb, A.mtl, A.ntl), 1, 1)
    out = HermitianMatrix(data=data, m=A.m, n=A.n, nb=nb, grid=A.grid,
                          uplo=Uplo.Lower)
    return out, Ts


def _he2hb_pq(A, tier):
    """he2hb on a p×q grid (``_he2hb_jit``). Returns ``(data, T)``."""
    g = A.grid
    p, q, nb, n, nt = g.p, g.q, A.nb, A.n, A.nt
    mtl, ntl = A.mtl, A.ntl
    dev = A.data.device
    kt = max(nt - 1, 0)
    data = A.data.clone()
    Ts = data.new_zeros((max(kt, 1), nb, nb))
    er = masks.local_elem_rows(mtl, nb, p, dev)              # [p, mtl, nb]
    ec = masks.local_elem_cols(ntl, nb, q, dev)              # [q, ntl, nb]
    for k in range(kt):
        start = (k + 1) * nb
        pan, V, T = _qr_panel_pq(_gather_col_panel(data, k), start, n)
        _put_col_panel(data, k, pan)
        Ts[k] = T
        # the trailing window: slots from ((k+1) // p, (k+1) // q)
        a_lo, a_hi = (k + 1) // p, cdiv(nt, p)
        b_lo, b_hi = (k + 1) // q, cdiv(nt, q)
        R, B = a_hi - a_lo, b_hi - b_lo
        aw = data[:, :, a_lo:a_hi, b_lo:b_hi]                # a view of data
        r_el = er[:, a_lo:a_hi].view(p, 1, R, 1, nb, 1)
        c_el = ec[:, b_lo:b_hi].view(1, q, 1, B, 1, nb)
        trail = (r_el >= start) & (c_el >= start) & (r_el < n) & (c_el < n)
        v_rows = _slots(V, masks.local_tile_rows(mtl, p, dev)[:, a_lo:a_hi],
                        nb)                                  # [p, R, nb, nb]
        v_cols = _slots(V, masks.local_tile_cols(ntl, q, dev)[:, b_lo:b_hi],
                        nb)                                  # [q, B, nb, nb]
        # Y = A₂₂·V from the lower triangle: rows by rank row (psum_cols)
        a_low = torch.where(trail & (r_el >= c_el), aw, 0)
        y1 = tier_mm(a_low.permute(0, 1, 2, 4, 3, 5).reshape(
            p, q, R * nb, B * nb), v_cols.reshape(q, B * nb, nb), tier)
        y1 = comm.psum_cols(y1)[:, :1]                       # [p, 1, R·nb, nb]
        # … plus the conjugated strict part's columns (psum_rows)
        a_str = torch.where(trail & (r_el > c_el), aw, 0).conj()
        z1 = tier_mm(a_str.permute(0, 1, 3, 5, 2, 4).reshape(
            p, q, B * nb, R * nb), v_rows.reshape(p, 1, R * nb, nb), tier)
        z1 = comm.psum_rows(z1)[:1]                          # [1, q, B·nb, nb]
        y_loc = y1.new_zeros((p, 1, mtl, nb, nb))
        y_loc[:, :, a_lo:a_hi] = y1.view(p, 1, R, nb, nb)
        z_loc = z1.new_zeros((1, q, ntl, nb, nb))
        z_loc[:, :, b_lo:b_hi] = z1.view(1, q, B, nb, nb)
        y_full = comm.allgather_cyclic(y_loc, p, comm.AXIS_P)[0, 0]
        z_full = comm.allgather_cyclic(z_loc, q, comm.AXIS_Q)[0, 0]
        L = min(z_full.shape[0], y_full.shape[0])
        z_fit = torch.zeros_like(y_full)                     # the z_fit crop
        z_fit[:L] = z_full[:L]
        Y = (y_full + z_fit).reshape(-1, nb)[start:n]
        Vs = V[start:n]
        with full_f32_matmul():
            X = Y @ T
            Ws = X - 0.5 * (Vs @ (T.mH @ (Vs.mH @ X)))
        W = torch.zeros_like(V)
        W[start:n] = Ws
        w_rows = _slots(W, masks.local_tile_rows(mtl, p, dev)[:, a_lo:a_hi],
                        nb)
        w_cols = _slots(W, masks.local_tile_cols(ntl, q, dev)[:, b_lo:b_hi],
                        nb)
        # A₂₂ ← A₂₂ − W·Vᴴ − V·Wᴴ as one product over the ranks
        rows = torch.cat([w_rows, v_rows], dim=-1)           # [p, R, nb, 2nb]
        cols = torch.cat([v_cols.mH, w_cols.mH], dim=-2)     # [q, B, 2nb, nb]
        aw -= _outer_pq(rows.unsqueeze(1), cols.unsqueeze(0), tier)
    return data, Ts


def he2hb_gather(Aband: HermitianMatrix) -> torch.Tensor:
    """The band in lower storage ``band[d, j] = A[j+d, j]``, d = 0..nb
    (reference he2hbGather), from the 2·nt band tiles on the device."""
    return gather_band_lower(Aband)


def unmtr_he2hb(trans: Op, Aband: HermitianMatrix, T, C: Matrix,
                opts=None) -> Matrix:
    """Apply Q from he2hb to C (reference src/unmtr_he2hb.cc): Q·C for
    NoTrans (panels in reverse order), Qᴴ·C otherwise (forward order).
    Returns the new C."""
    notrans = trans == Op.NoTrans
    nb, n = Aband.nb, Aband.n
    C = C.materialize()
    slate_error_if(C.nb != nb or C.m != n,
                   f"unmtr_he2hb dims: Q is {n}×{n} nb={nb}, C is "
                   f"{C.m}×{C.n} nb={C.nb}")
    kt = T.shape[0] if Aband.nt > 1 else 0
    if C.grid.size > 1:
        c = C.data.clone()
        for k in (range(kt - 1, -1, -1) if notrans else range(kt)):
            V = extract_v(_gather_col_panel(Aband.data, k), (k + 1) * nb, n)
            Top = T[k] if notrans else T[k].mH
            _reflect_left_pq(c, V, Top, k + 1, 0, C.mt, C.nt)
        return C._replace(data=c)
    av = tiles_to_dense(Aband.data[0, 0], Aband.mtl * nb, Aband.ntl * nb)
    c = tiles_to_dense(C.data[0, 0], C.mtl * nb, C.ntl * nb)  # in place
    with full_f32_matmul():
        for k in (range(kt - 1, -1, -1) if notrans else range(kt)):
            start = (k + 1) * nb
            V = extract_v(av[:, k * nb:start], start, n)[start:n]
            Top = T[k] if notrans else T[k].mH
            cc = c[start:n]                              # a view of c
            cc.sub_(V @ (Top @ (V.mH @ cc)))
    return C._replace(data=dense_to_tiles(c, nb, C.mtl, C.ntl)[None, None])


def hb2st(band: torch.Tensor):
    """Hermitian band → real tridiagonal by bulge chasing (reference
    src/hb2st.cc): ``(d, e, V, tau)`` on the band's device, d and e of
    the real dtype, the packed reflectors for :func:`unmtr_hb2st`.

    On the card this is the hand-written chase kernel (B16) or an error:
    there is no other rung. The JAX package's other rungs (the XLA wave,
    the host C++ chase) are other implementations of the same function
    and are not ported; the CPU runs the kernel's plain version. Its
    validator is kept from the JAX ladder (``robust/ladder.py:235-241``):
    a non-finite d or e raises :class:`SlateError`, which is where the
    ladder ends once every rung has failed on such an input."""
    d, e, V, tau = kernels.hb2st_chase(band)
    if not bool(torch.isfinite(d).all() & torch.isfinite(e).all()):
        raise SlateError("hb2st: non-finite tridiagonal (the band holds a "
                         "NaN or Inf)")
    return d, e, V, tau


def unmtr_hb2st(V, tau, C: torch.Tensor, band: int,
                trans: Op = Op.NoTrans) -> torch.Tensor:
    """Apply Q from hb2st to the rows of C (reference
    src/unmtr_hb2st.cc): Q·C for NoTrans, Qᴴ·C otherwise."""
    notrans = trans == Op.NoTrans
    return apply_bulge_reflectors(V, tau, C, band, forward=not notrans,
                                  conj_tau=notrans)


def two_stage_chase_band(n: int, nb: int, band_nb: int) -> int:
    """The band both two-stage pipelines (heev, gesvd) chase at: they
    re-block an nb-tiled matrix to ``band_nb`` only when nb > band_nb and
    n > 2·band_nb, else they chase at nb."""
    return band_nb if (nb > band_nb and n > 2 * band_nb) else nb


def reblock(A, band_nb: int):
    """A at tile size ``band_nb``: tile-level :meth:`retile` when it
    divides nb, else through the dense matrix."""
    if A.nb % band_nb == 0:
        return A.retile(band_nb)
    return type(A).from_dense(A.to_dense(), nb=band_nb, grid=A.grid,
                              uplo=A.uplo)


def heev_two_stage(A: HermitianMatrix, opts=None, want_vectors=True,
                   times=None):
    """The whole two-stage pipeline (reference src/heev.cc:104-172):
    he2hb → band gather → hb2st → sterf (values) or stedc/steqr
    (vectors) → unmtr_hb2st → unmtr_he2hb. Returns ``(lam, Z)``: lam
    ascending, a tensor of A's real dtype on its device; Z a Matrix or
    None. ``times``, a dict, receives each stage's host-clock seconds,
    with the device synchronised at each boundary; None (the default)
    times nothing and adds no synchronisation."""
    from .eig import sterf, steqr, stedc
    rdt = A.dtype.to_real() if A.dtype.is_complex else A.dtype
    method = get_option(opts, Option.MethodEig, MethodEig.Auto)
    band_nb = get_option(opts, Option.EigBand,
                         preferred_eig_band(A.n, A.dtype, A.grid.device))
    if two_stage_chase_band(A.n, A.nb, band_nb) != A.nb:
        A = reblock(A, band_nb)
    clock = _StageClock(times, A.grid.device)
    Aband, T = clock("he2hb", he2hb, A, opts)
    band = clock("gather", he2hb_gather, Aband)
    d, e, V2, tau2 = clock("hb2st", hb2st, band)
    if not want_vectors:
        lam = clock("sterf", sterf, d, e)
        return torch.as_tensor(lam).to(A.grid.device, rdt), None
    if method == MethodEig.QR or (method != MethodEig.DC and A.n <= 128):
        if A.n > 512:
            # values by host QR iteration, vectors by batched inverse
            # iteration on the device (linalg/stein.py), as the JAX
            # package's steqr with a grid
            lam, ztri = clock("steqr", steqr, d, e, True, A.grid.device,
                              rdt, times)
        else:
            lam, ztri = clock("steqr", steqr, d, e)
            ztri = torch.from_numpy(ztri).to(A.grid.device, rdt)
    else:
        lam, ztri = clock("stedc", stedc, d, e, True, A.grid.device, rdt)
    # the real tridiagonal's vectors, cast once to A's dtype
    zb = clock("unmtr_hb2st", unmtr_hb2st, V2, tau2, ztri.to(A.dtype), A.nb)
    Zb = Matrix.from_dense(zb, nb=A.nb, grid=A.grid)
    Z = clock("unmtr_he2hb", unmtr_he2hb, Op.NoTrans, Aband, T, Zb, opts)
    return torch.as_tensor(lam).to(A.grid.device, rdt), Z


class _StageClock:
    """Runs a stage and, when a ``times`` dict is given, adds its
    host-clock seconds there with the device synchronised at both
    ends."""

    def __init__(self, times, device):
        self.times = times
        self.cuda = torch.device(device).type == "cuda"

    def __call__(self, name, fn, *args):
        if self.times is None:
            return fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        return out
