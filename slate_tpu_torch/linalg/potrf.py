"""Cholesky: potrf / potrs / posv and the band Cholesky pbtrf / pbtrs /
pbsv (reference src/potrf.cc, src/potrs.cc, src/posv.cc, src/pbtrf.cc,
src/pbtrs.cc, src/pbsv.cc; counterpart of ``slate_tpu/linalg/potrf.py``).

On one rank the factorization is the right-looking blocked loop over the
block columns of the dense matrix: symmetrise and factor the diagonal
tile, solve the panel below it, subtract the panel's product from the
lower triangle of the trailing matrix. The port runs eagerly and updates
the dense copy in place (panel write-back and trailing update), so the
peak is the matrix, its dense copy and one panel.

On a p×q grid it is the JAX package's SPMD program over the rank-stacked
tiles (``potrf.py:101-228``, ``:484-847``): lcm(p, q)-aligned super-step
chunks, each a loop over its block columns that broadcasts the diagonal
tile, factors it once (K1), solves the owner column's panel (K2),
gathers the panel to every rank and applies its update one tile column
at a time, over the rows at and below the column's diagonal tile (the
lower trapezoid's flops; one product over the whole trailing window, as
the JAX body does, would double them). ``Option.PipelineDepth`` is
accepted and changes nothing (one schedule: the ranks share one
stream).

Numerical failure (not positive definite) is reported through ``info``,
the 1-based index of the first failing block column (0 = success), a
0-dim int32 tensor on the matrix's device.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from ..internal import band_packed as _bp
from ..internal import comm, masks
from ..internal.precision import (full_f32_matmul, resolve_tier,
                                  tier_context, tier_lhs, tier_rhs)
from ..internal.tile_kernels import (_factor_dtype, hermitian_tile,
                                     tile_potrf, tile_trsm_right_lower_t)
from ..matrix import (HermitianMatrix, Matrix, TriangularMatrix,
                      bc_from_tiles, cdiv, check_rhs_dtype, conj_transpose,
                      dense_to_tiles, tiles_to_dense)
from ..ops.blas import trsm
from ..ops.norms import norm
from ..robust.guards import finite_guard, health_report
from ..types import Diag, Norm, Side, Uplo, superstep_chunk
from . import band as _band
from .condest import pocondest


def potrf(A: HermitianMatrix, opts=None, health: bool = False):
    """Cholesky factor A = L·Lᴴ (lower) or Uᴴ·U (upper).

    Returns ``(L, info)``: a TriangularMatrix sharing A's geometry and
    an int32 scalar tensor (0 ⇒ success, else 1-based index of the first
    non-positive-definite block column). A is not modified.

    ``health=True`` returns a :class:`~..robust.guards.HealthReport` in
    the info slot: the same info, the first bad tile, and an rcond
    estimate by ``pocondest`` when the factor succeeded (host-synced;
    not for inner loops).
    """
    slate_error_if(A.m != A.n, "potrf needs a square matrix")
    Anorm = float(norm(Norm.One, A)) if health else None
    if A.uplo == Uplo.Upper:
        # Factor the mirrored lower problem; return the upper view.
        Alow = HermitianMatrix(data=_conj_transpose_data(A), m=A.m, n=A.n,
                               nb=A.nb, grid=A.grid, uplo=Uplo.Lower)
        L, info = potrf(Alow, opts)
        U = TriangularMatrix(data=_conj_transpose_data(L), m=A.m, n=A.n,
                             nb=A.nb, grid=A.grid, uplo=Uplo.Upper,
                             diag=Diag.NonUnit)
        if health:
            return U, _potrf_health(U, info, Anorm, opts)
        return U, info
    tier = resolve_tier(opts)
    if A.grid.size > 1:
        data, info = _potrf_pq(A, opts, tier)
    else:
        # On one device the port always takes the dense loop: the JAX
        # package caps it at 64 block columns only because it unrolls
        # the loop at trace time; an eager loop has no trace to grow.
        data, info = _potrf_dense_1dev(A, tier)
    L = TriangularMatrix(data=data, m=A.m, n=A.n, nb=A.nb, grid=A.grid,
                         uplo=Uplo.Lower, diag=Diag.NonUnit)
    if health:
        return L, _potrf_health(L, info, Anorm, opts)
    return L, info


def _potrf_health(L, info, Anorm, opts):
    """HealthReport for a finished potrf: the first bad tile from the
    first-failure convention; rcond by ``pocondest`` when the factor
    succeeded and ‖A‖₁ is nonzero."""
    i = int(info)
    growth = None
    if i == 0 and Anorm:
        growth = float(pocondest(Norm.One, L, Anorm, opts))
    return health_report("potrf", i, convention="first_block", growth=growth)


def _conj_transpose_data(A):
    """Conj-transposed storage of a square matrix, via the canonical
    materialize path."""
    G = Matrix(data=A.data, m=A.m, n=A.n, nb=A.nb, grid=A.grid)
    return conj_transpose(G).materialize().data


def _syrk_update_inplace(a, r0, nsub, vl, vr, cutoff=2048):
    """a[r0:r0+nsub, r0:r0+nsub] −= v·vᴴ in place, touching (mostly) only
    the lower-triangular blocks: recursive 2×2 split — the diagonal
    halves recurse, the off-diagonal quarter is one rectangular product.
    Saves ~45% of the flops a full square product would spend on the
    (junk-by-contract) upper half. ``vl`` and ``vr`` are v and vᵀ as the
    tier multiplies them (:func:`~..internal.precision.tier_lhs`,
    ``tier_rhs``), split once for the whole recursion; the caller holds
    the tier's matmul setting. ``a`` may be a stack [batch, ·, ·], with
    ``vl`` and ``vr`` stacks of the same batch (the batched drivers)."""
    sub = torch.Tensor.addmm_ if a.dim() == 2 else torch.Tensor.baddbmm_
    if nsub <= cutoff:
        sub(a[..., r0:r0 + nsub, r0:r0 + nsub], vl, vr, alpha=-1)
        return
    h = nsub // 2
    _syrk_update_inplace(a, r0, h, vl[..., :h, :], vr[..., :h], cutoff)
    sub(a[..., r0 + h:r0 + nsub, r0:r0 + h], vl[..., h:, :], vr[..., :h],
        alpha=-1)
    _syrk_update_inplace(a, r0 + h, nsub - h, vl[..., h:, :], vr[..., h:],
                         cutoff)


def _potrf_dense_loop(a, nb, n, Mp, tier):
    """Blocked Cholesky in place on a dense [Mp, ≥Mp] tensor (rows ≥ n
    padded with an identity diagonal by the caller); returns ``info``.
    The panels run at full FP32, the trailing update at ``tier``."""
    nt = cdiv(n, nb)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    fd = _factor_dtype(a.dtype)
    cplx = a.dtype.is_complex
    for k in range(nt):
        r0 = k * nb
        akk = hermitian_tile(a[r0:r0 + nb, r0:r0 + nb])
        lkk, info = finite_guard(tile_potrf(akk), info, k + 1, diag=True,
                                 cplx=cplx)
        a[r0:r0 + nb, r0:r0 + nb] = lkk.tril()
        if r0 + nb < Mp:
            with full_f32_matmul():
                pan = tile_trsm_right_lower_t(
                    lkk.to(fd), a[r0 + nb:, r0:r0 + nb].to(fd)).to(a.dtype)
            pan, info = finite_guard(pan, info, k + 1, cplx=cplx)
            a[r0 + nb:, r0:r0 + nb] = pan          # panel write-back
            vl, vr = tier_lhs(pan, tier), tier_rhs(pan.mH, tier)
            with tier_context(tier, a.dtype):
                _syrk_update_inplace(a, r0 + nb, Mp - r0 - nb, vl, vr)
    return info


def potrf_dense_inplace(a: torch.Tensor, nb: int = 1024, group: int = 16,
                        opts=None):
    """Lower Cholesky factor of a dense square tensor, in place (the JAX
    package's donated large-n entry, potrf.py:395-425): the blocked loop
    of :func:`_potrf_dense_loop` on the caller's storage, with none of
    the tiles ⇄ dense copies of :func:`potrf`, so the peak is the matrix
    and one panel. ``group`` is kept for the JAX signature, where it
    bounds the block columns of one jit program; an eager loop has no
    such limit, so it has no effect here. The lower
    triangle is read and the factor's is the only meaningful one (the
    trailing updates write part of the upper). n must be a multiple of
    nb. Returns ``(a, info)``: ``a`` the same
    storage, ``info`` the 1-based first failing block column (0 =
    success)."""
    slate_error_if(not isinstance(a, torch.Tensor) or a.dim() != 2
                   or a.shape[0] != a.shape[1],
                   "potrf_dense_inplace needs a square 2-D tensor")
    slate_error_if(not (a.is_floating_point() or a.is_complex())
                   or not a.is_contiguous(),
                   "potrf_dense_inplace needs a contiguous floating or "
                   "complex tensor (its storage is factored in place)")
    n = a.shape[0]
    slate_error_if(n % nb != 0,
                   "potrf_dense_inplace: n must be a multiple of nb")
    return a, _potrf_dense_loop(a, nb, n, n, resolve_tier(opts))


def _potrf_dense_1dev(A, tier):
    """Single-device path: blocked Cholesky of the dense (padded)
    matrix, then back to tiles."""
    nb = A.nb
    n = A.n
    nt = cdiv(n, nb)
    mtl, ntl = A.mtl, A.ntl
    Mp = mtl * nb
    a = tiles_to_dense(A.data[0, 0], Mp, ntl * nb)   # a new tensor
    if Mp > n:  # identity on the padded diagonal (cf. tile_diag_pad_identity)
        pad = torch.arange(n, min(Mp, ntl * nb), device=a.device)
        a[pad, pad] = 1.0
    info = _potrf_dense_loop(a, nb, n, Mp, tier)
    if min(Mp, ntl * nb) > nt * nb:
        # tiles past the last real block column stay zero; in-tile
        # diagonal padding of block nt-1 keeps its identity, matching
        # tile_diag_pad_identity
        pad = torch.arange(nt * nb, min(Mp, ntl * nb), device=a.device)
        a[pad, pad] = 0.0
    tiles = dense_to_tiles(a, nb, mtl, ntl)
    return bc_from_tiles(tiles, 1, 1), info


# ---------------------------------------------------------------------------
# p×q grid: super-step chunks of the SPMD factorization
# ---------------------------------------------------------------------------

def _potrf_pq(A, opts, tier):
    """The p×q factorization (``potrf.py:101-228`` without checkpoints,
    fault injection and tuning): lcm(p, q)-aligned chunks of
    :func:`superstep_chunk` block columns once there are at least two
    chunks' worth, else one chunk over every block column. Returns
    ``(data, info)``, the factor in a new rank-stacked tensor."""
    g = A.grid
    nt = A.nt
    lcm_pq = comm.lcm(g.p, g.q)
    S = superstep_chunk(nt, lcm_pq, opts) if nt >= 2 * lcm_pq else nt
    data = A.data.clone()
    info = torch.zeros((), dtype=torch.int32, device=data.device)
    for k0 in range(0, nt, S):
        info = _potrf_chunk_core(A, data, info, k0, min(S, nt - k0), tier)
    return data, info


class _PotrfSteps:
    """The per-step operations of a p×q chunk on the rank-stacked tiles
    ``data`` (updated in place).

    A gathered panel of step k is a :class:`_Panel`: the L tiles below
    the diagonal in global tile-row order from ``base = (k // p)·p`` (the
    JAX body's ``allgather_panel_rows`` of the masked column), and the
    same tiles in each rank row's slot order, the left operand of every
    tile-column update of the step."""

    def __init__(self, A, data, tier):
        g = A.grid
        self.p, self.q, self.nb = g.p, g.q, A.nb
        self.n, self.nt, self.mtl = A.n, A.nt, A.mtl
        self.data = data
        self.tier = tier
        self.cplx = data.dtype.is_complex
        self.gi = masks.local_tile_rows(self.mtl, self.p, data.device)

    def factor(self, k, info):
        """Factor panel k: the diagonal tile broadcast from its owner and
        factored once (K1), the owner column's panel solved (K2) and
        written back, the panel gathered to every rank. Returns
        ``(info, panel)``."""
        p, q, nb, d = self.p, self.q, self.nb, self.data
        akk = comm.bcast_from_owner(d[:, :, k // p, k // q], k % p,
                                    k % q)[0, 0]
        akk = hermitian_tile(masks.tile_diag_pad_identity(akk, k, self.n,
                                                          nb))
        lkk, info = finite_guard(tile_potrf(akk), info, k + 1, diag=True,
                                 cplx=self.cplx)
        c0, kc, lo = k % q, k // q, k // p
        blk = d[:, c0, lo:, kc]                       # [p, R, nb, nb]
        R = blk.shape[1]
        gi = self.gi[:, lo:, None, None]
        new = blk
        if k + 1 < self.nt:          # tiles past nt are zero padding
            fd = _factor_dtype(d.dtype)
            with full_f32_matmul():
                solved = tile_trsm_right_lower_t(
                    lkk.to(fd), blk.reshape(p * R * nb, nb).to(fd))
            solved = solved.to(d.dtype).view(p, R, nb, nb)
            new = torch.where(gi > k, solved, blk)
        new = torch.where(gi == k, lkk.tril(), new)
        d[:, c0, lo:, kc] = new
        below = torch.where(gi > k, new, torch.zeros_like(new))
        full = comm.allgather_panel_rows(
            below.unsqueeze(1).expand(p, q, R, nb, nb), p, c0)[0, 0]
        return info, _Panel(full, lo * p, p, self.tier)

    def advance(self, s, j, pan):
        """Step s's update of tile column j alone: the tiles of rank rows
        from slot j // p down (the lower part of the column and at most
        one tile above it per rank row) minus L·L[j]ᴴ, one product
        batched over the rank rows."""
        p, q, nb, d = self.p, self.q, self.nb, self.data
        a_lo = j // p
        lcol = pan.full[j - pan.base]
        if self.cplx:
            lcol = lcol.conj()
        lrows = pan.rows(a_lo)                        # [p, Ra·nb, nb]
        with tier_context(self.tier, d.dtype):
            upd = torch.matmul(lrows, tier_rhs(lcol.mT, self.tier))
        Ra = lrows.shape[1] // nb
        d[:, j % q, a_lo:, j // q] -= upd.view(p, Ra, nb, nb)


class _Panel:
    """A gathered panel: ``full`` [R·p, nb, nb] in global tile-row order
    from tile ``base``, and its rows in each rank row's slot order, split
    once for the trailing tier (``tier_lhs``)."""

    def __init__(self, full, base, p, tier):
        self.full, self.base, self.p = full, base, p
        R = full.shape[0] // p
        nb = full.shape[-1]
        slots = full.view(R, p, nb, nb).transpose(0, 1).reshape(
            p, R * nb, nb)
        self._lhs = tier_lhs(slots, tier)
        self._nb = nb

    def rows(self, a_lo):
        """Rows of each rank row's slots from ``a_lo`` down, [p, ·, k]."""
        off = (a_lo - self.base // self.p) * self._nb
        return self._lhs[:, off:]


def _potrf_chunk_core(A, data, info, k0, klen, tier=None):
    """One chunk over block columns [k0, k0 + klen) (``potrf.py:
    484-598``): factor panel k, then its update of every tile column
    k < j < nt. ``k0`` is a multiple of lcm(p, q), so the window of slots
    from (k0 // p, k0 // q) is itself block-cyclic. Updates ``data`` in
    place; returns ``info``."""
    st = _PotrfSteps(A, data, tier)
    for k in range(k0, k0 + klen):
        info, pan = st.factor(k, info)
        for j in range(k + 1, A.nt):
            st.advance(k, j, pan)
    return info


def potrs(L: TriangularMatrix, B: Matrix, opts=None) -> Matrix:
    """Solve A·X = B given the Cholesky factor (reference src/potrs.cc):
    L·Y = B then Lᴴ·X = Y (lower), or Uᴴ·Y = B then U·X = Y (upper)."""
    if L.uplo == Uplo.Upper:
        Y = trsm(Side.Left, 1.0, conj_transpose(L), B, opts)
        return trsm(Side.Left, 1.0, L, Y, opts)
    Y = trsm(Side.Left, 1.0, L, B, opts)
    return trsm(Side.Left, 1.0, conj_transpose(L), Y, opts)


def posv(A: HermitianMatrix, B: Matrix, opts=None):
    """Solve A·X = B by Cholesky (reference src/posv.cc).
    Returns (X, L, info)."""
    L, info = potrf(A, opts)
    X = potrs(L, B, opts)
    return X, L, info


def posv_batched(a, b, opts=None, *, nb: int | None = None, device=None):
    """SPD solve of a dense ``[batch, n, n]`` stack and ``[batch, n,
    nrhs]`` right-hand sides, the serving-path sibling of :func:`posv`
    (``serve.batched.batched_posv``). Returns ``(x, l, info)`` with one
    info a member."""
    from ..serve.batched import batched_posv
    return batched_posv(a, b, opts, nb=nb, device=device)


# ---------------------------------------------------------------------------
# band Cholesky (``potrf.py:877-926``): packed lower band storage, a
# sliding dense window per block column (``linalg/band.py``)
# ---------------------------------------------------------------------------

def pbtrf(A, opts=None, health: bool = False):
    """Band Cholesky of a Hermitian band A (reference src/pbtrf.cc).
    Returns ``(BandCholFactor, info)``: the packed lower factor
    (``.to_dense()`` gives L) and info as :func:`potrf`'s, the 1-based
    first non-SPD block column of the band block. ``health=True`` returns
    a :class:`~..robust.guards.HealthReport` in the info slot, with the
    same first-block convention."""
    Am = A.materialize()          # resolves op views; flips uplo, kl, ku
    slate_error_if(Am.m != Am.n, "pbtrf needs a square matrix")
    upper = Am.uplo == Uplo.Upper
    kd = Am.ku if upper else Am.kl
    nbw = _bp._band_block(Am.n, kd)
    ncols = cdiv(Am.n, nbw) * nbw + nbw + kd
    ab = _bp.pack_tiled(Am, kd, 0, ncols,
                          mode="mirror_upper" if upper else "full")
    ab, info = _band.pbtrf_packed(ab, Am.n, kd, nbw)
    F = _band.BandCholFactor(ab, Am.n, kd)
    if health:
        return F, health_report("pbtrf", int(info), convention="first_block")
    return F, info


def pbtrs(L, B: Matrix, opts=None) -> Matrix:
    """Solve A·X = B from :func:`pbtrf`'s factor (reference
    src/pbtrs.cc)."""
    slate_error_if(L.n != B.m, "pbtrs dims")
    _bp.check_same_device(L.ab, B, "pbtrs")
    Bm = check_rhs_dtype(B.materialize(), L.ab.dtype)
    nbw = _bp._band_block(L.n, L.kd)
    b = _bp._b_to_dense(Bm, cdiv(L.n, nbw) * nbw + L.kd)
    x = _band.pbtrs_packed(L.ab, b, L.n, L.kd, nbw)
    return _bp._dense_to_b(x, Bm)


def pbsv(A, B: Matrix, opts=None):
    """Solve A·X = B by band Cholesky (reference src/pbsv.cc). Returns
    ``(X, L, info)``."""
    L, info = pbtrf(A, opts)
    X = pbtrs(L, B, opts)
    return X, L, info
