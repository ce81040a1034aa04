"""Two-stage SVD: ge2tb (general → upper triangular band),
the band gather, the tb2bd dispatch, the back-transforms and the whole
pipeline (reference src/ge2tb.cc, src/tb2bd.cc, src/bdsqr.cc,
src/gesvd.cc:77-102; counterpart of ``slate_tpu/linalg/ge2tb.py``).

On a 1×1 grid the JAX package's ``shard_map`` loop collapses to slices
of one dense copy, updated in place. Per block k: a QR panel on block
column k (rows ≥ k·nb) with the left update A ← A − V·Tᴴ·(Vᴴ·A) of the
columns right of it, then an LQ panel on block row k (columns ≥ (k+1)·nb),
factored as the QR of its conjugate transpose, with the right update
A ← A − (A·V)·T·Vᴴ of the rows below it. The panels go through
``torch.geqrf`` (``panel_qr_factor``), as the JAX package's go through
XLA's ``geqrf``; their T as in ``he2hb.panel_t``. The result is an upper
band of width nb + 1 with the QR reflectors below the diagonal and the
LQ reflectors right of the superdiagonal — LAPACK gebrd's layout at
block scale. Real and complex dtypes; the bidiagonal stage runs in the
real dtype and the singular values come out in it.

On a p×q grid of virtual ranks ge2tb and unmbr_ge2tb_v are the JAX
package's SPMD loops (``ge2tb.py:61-168``, ``:252-302``) over the
rank-stacked tiles: the QR panel of tile column k gathered down the grid
rows and its left update through ``psum_rows``; the LQ panel of tile
row k gathered along the grid columns, conjugate-transposed into a
column panel, and its right update through ``psum_cols``; each update on
the window of trailing slots, one product batched over the ranks for
each side of it (``geqrf._reflect_left_pq``, ``_reflect_right_pq``).
unmbr_ge2tb_u is the p×q ``unmqr``.
"""

from __future__ import annotations

import torch

from ..errors import SlateError, slate_error_if
from ..internal import kernels
from ..internal.band_wave import preferred_eig_band
from ..internal.precision import full_f32_matmul
from ..internal.tile_kernels import extract_v, panel_qr_factor
from ..matrix import (Matrix, bc_from_tiles, conj_transpose, dense_to_tiles,
                      tiles_to_dense)
from ..types import Op, Option, Side, get_option
from .bulge import apply_bulge_reflectors, bdsqr, gather_band_upper
from .geqrf import (_gather_col_panel, _gather_row_panel, _put_col_panel,
                    _put_row_panel, _qr_panel_pq, _reflect_left_pq,
                    _reflect_right_pq, panel_t)
from .he2hb import _StageClock, reblock, two_stage_chase_band


def ge2tb(A: Matrix, opts=None):
    """Reduce A (m ≥ n) to upper triangular band: A = U·B·Vᴴ. Returns
    ``(Aout, Tq, Tl)``: Aout stores the band and both reflector sets,
    Tq [nt, nb, nb] and Tl [max(nt − 1, 1), nb, nb]. A is not
    modified."""
    A = A.materialize()
    slate_error_if(A.m < A.n, "ge2tb v1 expects m >= n")
    nb, m, n = A.nb, A.m, A.n
    mt, nt = A.mt, A.nt
    if A.grid.size > 1:
        return _ge2tb_pq(A)
    a = tiles_to_dense(A.data[0, 0], A.mtl * nb, A.ntl * nb)  # in place
    Tq = a.new_zeros((nt, nb, nb))
    Tl = a.new_zeros((max(nt - 1, 1), nb, nb))
    with full_f32_matmul():
        for k in range(nt):
            # QR panel of block column k, left update of the columns right
            r0, c1 = k * nb, (k + 1) * nb
            pan, taus = panel_qr_factor(a[:, r0:c1], r0, m)
            a[:, r0:c1] = pan
            V = extract_v(pan, r0, m)[r0:m]
            Tq[k] = T = panel_t(V, taus)
            C = a[r0:m, c1:nt * nb]                        # a view of a
            C.sub_(V @ (T.mH @ (V.mH @ C)))
            if k == nt - 1:
                break
            # LQ panel of block row k (the QR of its conjugate transpose),
            # right update of the rows below it
            pan, taus = panel_qr_factor(a[r0:c1, :].mH, c1, n)
            a[r0:c1, :] = pan.mH
            V = extract_v(pan, c1, n)[c1:n]
            Tl[k] = T = panel_t(V, taus)
            R = a[c1:mt * nb, c1:n]                        # a view of a
            R.sub_(((R @ V) @ T) @ V.mH)
    data = bc_from_tiles(dense_to_tiles(a, nb, A.mtl, A.ntl), 1, 1)
    return A._replace(data=data), Tq, Tl


def _ge2tb_pq(A):
    """ge2tb on a p×q grid (``_ge2tb_jit``): per k the QR panel of tile
    column k and its left update of the columns right of it, then the LQ
    panel of tile row k and its right update of the rows below it."""
    nb, m, n, mt, nt = A.nb, A.m, A.n, A.mt, A.nt
    data = A.data.clone()
    Tq = data.new_zeros((nt, nb, nb))
    Tl = data.new_zeros((max(nt - 1, 1), nb, nb))
    for k in range(nt):
        pan, V, Tq[k] = _qr_panel_pq(_gather_col_panel(data, k), k * nb, m)
        _put_col_panel(data, k, pan)
        _reflect_left_pq(data, V, Tq[k].mH, k, k + 1, mt, nt)
        if k == nt - 1:
            break
        start = (k + 1) * nb
        pan, V, Tl[k] = _qr_panel_pq(_gather_row_panel(data, k), start, n)
        _put_row_panel(data, k, pan)
        _reflect_right_pq(data, V, Tl[k], k + 1, k + 1, mt, nt)
    return A._replace(data=data), Tq, Tl


def ge2tb_gather(Aout: Matrix) -> torch.Tensor:
    """The (nb+1)-wide upper band ``ub[d, j] = A[j, j+d]``, d = 0..nb,
    from the 2·nt band tiles, on the device."""
    return gather_band_upper(Aout)


def tb2bd(ub: torch.Tensor):
    """Upper triangular band → real bidiagonal by bulge chasing
    (reference src/tb2bd.cc): ``(d, e, Vu, tauu, Vv, tauv, phase0)`` on
    the band's device, d and e of the real dtype, phase0 the column-0
    phase of a complex band (1 for a real one). On the card the hand-written chase kernel (B17)
    runs, or the call raises; the CPU runs its plain version. A
    non-finite d or e raises :class:`SlateError`, the validator of the
    JAX package's ladder."""
    out = kernels.tb2bd_chase(ub)
    if not bool(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()):
        raise SlateError("tb2bd: non-finite bidiagonal (the band holds a NaN "
                         "or Inf)")
    return out


def unmbr_ge2tb_u(trans: Op, Aout: Matrix, Tq, C: Matrix, opts=None):
    """Apply the U-side (QR panel) reflectors to C: the layout of
    ``unmqr`` over the ge2tb output (reference unmbr_ge2tb, U side)."""
    from .geqrf import unmqr
    return unmqr(Side.Left, trans, Aout, Tq, C, opts)


def unmbr_ge2tb_v(trans: Op, Aout: Matrix, Tl, C: Matrix, opts=None):
    """Apply the V-side (LQ panel) reflectors to C [n, ·]: NoTrans gives
    C ← Q₁⋯Q_K·C (panels in reverse order), Q_k = I − V_k·T_k·V_kᴴ with
    V_k from block row k of Aout (conjugate-transposed back to column
    form); otherwise the conjugate transpose, forward."""
    notrans = trans == Op.NoTrans
    nb, n = Aout.nb, Aout.n
    C = C.materialize()
    slate_error_if(C.nb != nb or C.m != n,
                   f"unmbr_ge2tb_v dims: Q is {n}×{n} nb={nb}, C is "
                   f"{C.m}×{C.n} nb={C.nb}")
    kt = Tl.shape[0] if Aout.nt > 1 else 0
    if C.grid.size > 1:
        c = C.data.clone()
        for k in (range(kt - 1, -1, -1) if notrans else range(kt)):
            V = extract_v(_gather_row_panel(Aout.data, k), (k + 1) * nb, n)
            Top = Tl[k] if notrans else Tl[k].mH
            _reflect_left_pq(c, V, Top, k + 1, 0, C.mt, C.nt)
        return C._replace(data=c)
    av = tiles_to_dense(Aout.data[0, 0], Aout.mtl * nb, Aout.ntl * nb)
    c = tiles_to_dense(C.data[0, 0], C.mtl * nb, C.ntl * nb)  # in place
    with full_f32_matmul():
        for k in (range(kt - 1, -1, -1) if notrans else range(kt)):
            start = (k + 1) * nb
            V = extract_v(av[k * nb:start, :].mH, start, n)[start:n]
            Top = Tl[k] if notrans else Tl[k].mH
            cc = c[start:n]                                # a view of c
            cc.sub_(V @ (Top @ (V.mH @ cc)))
    return C._replace(data=dense_to_tiles(c, nb, C.mtl, C.ntl)[None, None])


def gesvd_two_stage(A: Matrix, opts=None, want_u=False, want_vt=False,
                    times=None):
    """The two-stage SVD (reference gesvd.cc:77-102) for m ≥ n: ge2tb →
    band gather → tb2bd → bdsqr → the tb2bd and ge2tb back-transforms.
    Returns ``(s, U | None, VT | None)``: s descending, a tensor of A's
    real dtype on its device; U [m, n] and VT [n, n] Matrices, VT = Vᴴ.
    ``times`` as for ``heev_two_stage``."""
    band_nb = get_option(opts, Option.EigBand,
                         preferred_eig_band(min(A.m, A.n), A.dtype,
                                            A.grid.device))
    if two_stage_chase_band(min(A.m, A.n), A.nb, band_nb) != A.nb:
        A = reblock(A, band_nb)
    clock = _StageClock(times, A.grid.device)
    dev, dt = A.grid.device, A.dtype
    rdt = dt.to_real() if dt.is_complex else dt
    m, n = A.m, A.n
    Aout, Tq, Tl = clock("ge2tb", ge2tb, A, opts)
    ub = clock("gather", ge2tb_gather, Aout)
    d, e, Vu, tauu, Vv, tauv, phase0 = clock("tb2bd", tb2bd, ub)
    if not (want_u or want_vt):
        s = clock("bdsqr", bdsqr, d, e)
        return torch.as_tensor(s).to(dev, rdt), None, None
    s, Ubd, VbdT = clock("bdsqr", bdsqr, d, e, True)
    U = VT = None
    if want_u:
        # U = Q_u·[U₂·U_bd; 0]: the stage-2 reflectors, then stage 1's
        u2 = clock("unmbr_tb2bd", apply_bulge_reflectors, Vu, tauu,
                   torch.from_numpy(Ubd).to(dev, dt), A.nb)
        ub_full = u2.new_zeros((m, n))
        ub_full[:n] = u2
        U = clock("unmbr_ge2tb", unmbr_ge2tb_u, Op.NoTrans, Aout, Tq,
                  Matrix.from_dense(ub_full, nb=A.nb, grid=A.grid), opts)
    if want_vt:
        # V = Q_v·diag(phase0, 1, …)·V₂·V_bd, then VT = Vᴴ
        v2 = clock("unmbr_tb2bd", apply_bulge_reflectors, Vv, tauv,
                   torch.from_numpy(VbdT.T.copy()).to(dev, dt), A.nb)
        v2[0] *= phase0
        Vm = clock("unmbr_ge2tb", unmbr_ge2tb_v, Op.NoTrans, Aout, Tl,
                   Matrix.from_dense(v2, nb=A.nb, grid=A.grid), opts)
        VT = conj_transpose(Vm).materialize()
    return torch.as_tensor(s).to(dev, rdt), U, VT
