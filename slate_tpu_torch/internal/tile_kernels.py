"""Single-tile and panel dispatch sites (reference
include/slate/Tile_blas.hh; counterpart of
``slate_tpu/internal/tile_kernels.py:35-207`` and ``:303-430``).

Each site sends what :data:`kernels.CAPABILITY` admits to the port's own
kernel (its plain version on the CPU) and everything else to the
matching ``torch.linalg`` op, as the JAX package sends it to XLA.
"""

from __future__ import annotations

import torch

from . import kernels
from .precision import full_f32_matmul, tier_addmm


def tile_gemm(alpha, a: torch.Tensor, b: torch.Tensor, beta,
              c: torch.Tensor, tier: str = "bf16_6x") -> torch.Tensor:
    """alpha·a·b + beta·c; a new tensor. A contraction that
    :data:`kernels.CAPABILITY` admits for the rank-k tail (k below one
    128-lane tile) with Python-scalar alpha and beta goes to the port's
    kernel K11 at ``tier`` whatever the JAX package's ``rank_k`` rung
    says; anything else is one ``addmm`` at ``tier``."""
    if (isinstance(alpha, (int, float)) and isinstance(beta, (int, float))
            and a.dim() == 2 and b.dim() == 2 and c.dim() == 2
            and kernels.supported("rank_k_tail", a.dtype, a.shape[1],
                                  a.device)):
        return kernels.rank_k_tail(c, a, b, alpha=float(alpha),
                                   beta=float(beta), tier=tier)
    return tier_addmm(c, a, b, beta=beta, alpha=alpha, tier=tier)


def _factor_dtype(dt: torch.dtype) -> torch.dtype:
    """Low-precision tiles factor in f32 and cast back (storage precision
    is not panel compute precision)."""
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    return dt


def hermitian_tile(akk: torch.Tensor) -> torch.Tensor:
    """The full Hermitian tile from its lower half (the upper half is
    junk): the strict lower triangle mirrored conjugated and the real
    part of the diagonal, the only part LAPACK's potrf reads (the
    trailing updates leave rounding-level imaginary parts there). For a
    real tile this is tril + tril(-1)ᵀ, bit for bit."""
    low = akk.tril(-1)
    return low + low.mH + torch.diag_embed(
        torch.diagonal(akk, dim1=-2, dim2=-1).real.to(akk.dtype))


def tile_potrf(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of one [nb, nb] tile, or of each tile of a [batch, nb, nb]
    stack in one call → lower factor, upper zeroed. A failed
    factorization yields non-finite entries on the diagonal, as XLA's
    ``cholesky`` does, never an exception; in a stack only the failed
    member's."""
    fd = _factor_dtype(a.dtype)
    a32 = a.to(fd)
    if kernels.supported("potrf_tile", fd, a.shape[-1], a.device):
        return kernels.potrf_tile(a32).to(a.dtype)
    l, info = torch.linalg.cholesky_ex(a32)
    return torch.where((info == 0)[..., None, None], l,
                       torch.full_like(l, float("nan"))).to(a.dtype)


def tile_trsm_left_lower(l: torch.Tensor, b: torch.Tensor,
                         unit: bool = False,
                         trans: bool = False) -> torch.Tensor:
    """op(L)⁻¹·B with L lower and op = identity or (``trans``) the
    conjugate transpose, which is the transpose for a real L."""
    if not trans and kernels.supported("trsm_left_lower", l.dtype,
                                       l.shape[0], l.device):
        return kernels.trsm_left_lower(l, b, unit=unit)
    return torch.linalg.solve_triangular(l.mH if trans else l, b,
                                         upper=trans, left=True,
                                         unitriangular=unit)


def tile_trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor,
                            unit: bool = False) -> torch.Tensor:
    """B·L⁻ᴴ (B·L⁻ᵀ for a real L) — the potrf panel op."""
    if kernels.supported("trsm_right_lower_t", l.dtype, l.shape[0],
                         l.device):
        return kernels.trsm_right_lower_t(l, b, unit=unit)
    return torch.linalg.solve_triangular(l.mH, b, upper=True, left=False,
                                         unitriangular=unit)


def lu_nopiv_block(a: torch.Tensor, ib: int = 32):
    """Unpivoted LU of a square [nb, nb] block → ``(lu, info)``, compact
    unit-L/U; a zero pivot keeps its 0 on the diagonal and the
    elimination uses 1 in its place; ``info`` counts zero pivots. What
    :data:`kernels.CAPABILITY` admits goes to the port's kernel K7;
    anything else takes the ib-strip algorithm of
    ``tile_kernels.py:312-350`` in torch ops: short column chains on
    [nb, ib] strips, then a unit-lower solve and one product per strip."""
    if a.dim() == 2 and kernels.supported("lu_nopiv_tile", a.dtype,
                                          a.shape[-1], a.device):
        return kernels.lu_nopiv_tile(a)
    nb = a.shape[0]
    a = a.clone()
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    ib = min(ib, nb)
    for j0 in range(0, nb, ib):
        j_hi = min(j0 + ib, nb)
        S = a[:, j0:j_hi]                        # a view: updates land in a
        for jj in range(j_hi - j0):
            dj = j0 + jj
            piv = S[dj, jj]
            info += (piv == 0).int()
            lcol = S[dj + 1:, jj] / torch.where(piv == 0, 1.0, piv).to(a.dtype)
            S[dj + 1:, jj + 1:] -= torch.outer(lcol, S[dj, jj + 1:])
            S[dj + 1:, jj] = lcol
        if j_hi < nb:
            u12 = torch.linalg.solve_triangular(
                S[j0:j_hi], a[j0:j_hi, j_hi:], upper=False, left=True,
                unitriangular=True)
            a[j0:j_hi, j_hi:] = u12
            with full_f32_matmul():
                a[j_hi:, j_hi:] -= S[j_hi:] @ u12
    return a, info


def panel_lu_nopiv(panel: torch.Tensor, start: int, m: int):
    """Unpivoted LU of a full-height panel [M, nb] (reference
    getrf_nopiv.cc; ``tile_kernels.py:353-377``): the diagonal block
    [start, start + nb) by :func:`lu_nopiv_block` (K7 where
    :data:`kernels.CAPABILITY` admits it), then L21 = A21·U11⁻¹ for the
    rows [start + nb, m) in one triangular solve against the safe U11
    (a zero diagonal entry taken as 1). Rows outside the window keep
    their values. Returns new tensors ``(panel, info)``, ``info`` the
    number of zero pivots."""
    nb = panel.shape[1]
    d_f, info = lu_nopiv_block(panel[start:start + nb])
    out = panel.clone()
    out[start:start + nb] = d_f
    if m > start + nb:
        d = torch.diagonal(d_f)
        safe_u = d_f.triu() + torch.diag((d == 0).to(d_f.dtype))
        with full_f32_matmul():
            out[start + nb:m] = torch.linalg.solve_triangular(
                safe_u, panel[start + nb:m], upper=True, left=False)
    return out, info


# ---------------------------------------------------------------------------
# LU panel with partial pivoting (reference Tile_getrf.hh:161-300;
# tile_kernels.py:147-207)
# ---------------------------------------------------------------------------

def panel_lu_factor(panel: torch.Tensor, start: int, m: int,
                    max_rows: int | None = None):
    """Pivoted LU of the window [start, max(m, start + nb)) of a
    full-height panel [M, nb] (global row i at index i; the caller put an
    identity on padded diagonal entries, so padding self-pivots).

    Returns new tensors ``(panel, piv [nb] int32, info)``: the window as
    L (unit diagonal implicit) below and U on and above the diagonal, the
    rows outside it as they were; ``piv[j]`` the global row swapped with
    row start + j (LAPACK ipiv, 0-based); ``info`` the number of zero
    diagonal entries of U. The JAX package rolls the window to row 0 and
    zeroes the rest, to keep one static shape; the port slices it. A
    window that :data:`kernels.CAPABILITY` admits (its width, and on the
    card its height) goes to the port's physical-swap kernel K10, its
    plain version on the CPU, whatever the JAX package's ``panel_plu``
    rung says; any other to ``torch.linalg.lu_factor_ex``, the
    counterpart of ``lax.linalg.lu``. A pivot past the window (a NaN
    column) becomes a self-swap, as in the JAX package.

    ``max_rows``: a panel of more than ``max_rows`` rows takes the CALU
    tournament (:func:`_panel_lu_tournament`) instead, as the JAX package
    does where one ``lu`` call is limited by the TPU's scoped VMEM; no
    caller on one card sets it."""
    M, nb = panel.shape
    if max_rows is not None and M > max_rows:
        return _panel_lu_tournament(panel, start, m, max_rows)
    hi = max(m, start + nb)
    win = panel[start:hi]
    h = win.shape[0]
    fd = _factor_dtype(panel.dtype)
    if (kernels.supported("panel_plu_swap", fd, nb, panel.device)
            and (panel.device.type != "cuda" or h <= kernels.SWAP_H_MAX)):
        lu, piv_r, _ = kernels.panel_plu_swap(win.to(fd))
        piv_r = piv_r.long()
    else:
        lu, ipiv, _ = torch.linalg.lu_factor_ex(win.to(fd))
        piv_r = ipiv.long() - 1                  # LAPACK's 1-based ipiv
    out = panel.clone()
    out[start:hi] = lu.to(panel.dtype)
    info = (torch.diagonal(lu) == 0).sum().int()
    slot = torch.arange(nb, device=panel.device)
    piv = torch.where(piv_r < h, piv_r + start, slot + start).int()
    return out, piv, info


def _panel_lu_tournament(panel: torch.Tensor, start: int, m: int,
                         max_rows: int):
    """Tournament-pivot LU of a tall panel (CALU, reference
    src/getrf_tntpiv.cc; tile_kernels.py:210-300), with the contract of
    :func:`panel_lu_factor`.

    Each round splits the candidate rows into chunks of ``max_rows`` and
    keeps each chunk's nb winners by one batched
    ``torch.linalg.lu_factor_ex`` (the counterpart of the vmapped
    ``lax.linalg.lu``), until one chunk is left; a final LU of the
    survivors fixes the nb pivot rows and their elimination order. The
    window is then permuted by the LAPACK sequential-swap permutation,
    the winners' LU is its top block, and the rows below get
    L21 = A21·U11⁻¹ from one triangular solve. Pivot choices are CALU's,
    so |L| may exceed 1."""
    M, nb = panel.shape
    dev = panel.device
    fd = _factor_dtype(panel.dtype)
    hi = max(m, start + nb)
    h = hi - start
    win = panel[start:hi].to(fd)                 # the active window

    # phase A: tournament pivot selection over M candidates, as in the JAX
    # package (the window, then zero rows, so that the chunks are its
    # chunks); an index ≥ h marks a zero row, which loses every real round
    # (a win, in an all-zero column, resolves to a self-swap below)
    cand = win.new_zeros((M, nb))
    cand[:h] = win
    cand_idx = torch.arange(M, device=dev)
    R = M
    while R > max_rows:
        c = -(-R // max_rows)
        pad = c * max_rows - R
        cand = torch.cat([cand, cand.new_zeros((pad, nb))])
        cand_idx = torch.cat([cand_idx, torch.full((pad,), M, device=dev)])
        chunks = cand.reshape(c, max_rows, nb)
        _, ipiv, _ = torch.linalg.lu_factor_ex(chunks)
        sel = _ipiv_to_perm(ipiv.long() - 1, max_rows)[:, :nb]  # [c, nb]
        cand = torch.gather(chunks, 1, sel[:, :, None].expand(c, nb, nb))
        cand = cand.reshape(c * nb, nb)
        cand_idx = torch.gather(cand_idx.reshape(c, max_rows), 1,
                                sel).reshape(c * nb)
        R = c * nb
    lu_f, ipiv_f, _ = torch.linalg.lu_factor_ex(cand)
    perm_f = _ipiv_to_perm((ipiv_f.long() - 1)[None], R)[0]
    win_rows = cand_idx[perm_f[:nb]].tolist()   # winners, elim. order
    lu_top = lu_f[:nb]                          # LU of the permuted top
    info = (torch.diagonal(lu_f)[:nb] == 0).sum().int()

    # phase B: the LAPACK sequential-swap permutation. piv[j] is the slot
    # of winner j once swaps 0 … j−1 are applied; content[i] the original
    # window row whose data sits at slot i
    content = list(range(h))
    locof = list(range(h))
    piv_r = []
    for j in range(nb):
        t = win_rows[j]
        if t >= h:                   # pad winner (all-zero column)
            t = content[j]
        loc = locof[t]
        piv_r.append(loc)
        cj = content[j]
        content[j], content[loc] = t, cj
        locof[t], locof[cj] = j, loc
    permuted = win[torch.tensor(content, device=dev)]

    # the top block is done; the rows below get L21
    u11 = lu_top.triu()
    safe_u = u11 + torch.diag((torch.diagonal(u11) == 0).to(fd))
    l21 = torch.linalg.solve_triangular(safe_u, permuted[nb:], upper=True,
                                        left=False)
    out = panel.clone()
    out[start:start + nb] = lu_top.to(panel.dtype)
    out[start + nb:hi] = l21.to(panel.dtype)
    piv = (start + torch.tensor(piv_r, device=dev)).int()
    return out, piv, info


def _ipiv_to_perm(ipiv: torch.Tensor, rows: int) -> torch.Tensor:
    """Row permutations [c, rows] of a batch of 0-based LAPACK ipivs
    [c, r]: ``perm[b, i]`` is the original row at position i after the
    swaps, the ``permutation`` output of ``lax.linalg.lu``."""
    c, r = ipiv.shape
    perm = torch.arange(rows, device=ipiv.device).repeat(c, 1)
    bidx = torch.arange(c, device=ipiv.device)
    for j in range(r):
        p = ipiv[:, j]
        pj = perm[:, j].clone()
        perm[:, j] = perm[bidx, p]
        perm[bidx, p] = pj
    return perm


# ---------------------------------------------------------------------------
# Householder QR panel (reference internal_geqrf.cc; tile_kernels.py:380-430)
# ---------------------------------------------------------------------------

def panel_qr_factor(panel: torch.Tensor, start: int, m: int):
    """Householder QR of the window [start, m) of a full-height panel
    [M, nb] by ``torch.geqrf``, the counterpart of XLA's ``geqrf``.
    Returns new tensors ``(panel, taus [nb])``: the window in LAPACK
    layout, the rows outside it as they were; a window shorter than nb
    gives the columns past its height τ = 0, as the zero rows of the JAX
    package's rolled full-height panel do. The JAX package rolls the
    window to row 0 and masks the rest, to keep one static shape on the
    TPU; the port slices the window."""
    fd = _factor_dtype(panel.dtype)
    nb = panel.shape[1]
    qr_, taus = torch.geqrf(panel[start:m].to(fd))
    out = panel.clone()
    out[start:m] = qr_.to(panel.dtype)
    full = taus.new_zeros(nb)
    full[:taus.shape[0]] = taus
    return out, full.to(panel.dtype)


def extract_v(panel: torch.Tensor, start: int, m: int) -> torch.Tensor:
    """Unit-lower-trapezoid V from a factored panel [M, nb]:
    V[i, j] = panel[i, j] for start + j < i < m, 1 at i = start + j, 0
    elsewhere."""
    M, nb = panel.shape
    rows = torch.arange(M, device=panel.device)[:, None]
    diag = start + torch.arange(nb, device=panel.device)[None, :]
    v = torch.where((rows > diag) & (rows < m), panel, 0.0)
    return v + (rows == diag)


def larft(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Forward compact-WY T with H_0·H_1·… = I − V·T·Vᴴ (LAPACK larft),
    by the column recurrence on the Gram matrix VᴴV. V: [M, nb] unit
    lower trapezoid; T: [nb, nb] upper triangular."""
    nb = taus.shape[0]
    with full_f32_matmul():
        G = V.mH @ V
        T = torch.zeros((nb, nb), dtype=V.dtype, device=V.device)
        for j in range(nb):
            T[:j, j] = -taus[j] * (T[:j, :j] @ G[:j, j])
            T[j, j] = taus[j]
    return T
