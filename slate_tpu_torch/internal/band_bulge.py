"""Band bulge chasing in plain PyTorch: hb2st (symmetric band → real
symmetric tridiagonal) and tb2bd (upper triangular band → real upper
bidiagonal) — the port's own copy of the numpy twin
``slate_tpu/internal/band_bulge.py`` (reference src/hb2st.cc,
src/tb2bd.cc and their hebr/gebr task types).

Its :func:`hb2st` and :func:`tb2bd` are the plain versions of the two
chase kernels (``csrc/band_chase.cu``, wrapped in
:mod:`.kernels`): they walk the tasks one by one in the twin's order
(sweep by sweep, each sweep's chase in turn), with the twin's
``larfg`` convention, on any device. The CPU runs them; on the card they
are what the kernels are checked against.

The working storage is the band *ribbon*: element (r, c) of the matrix
lives at ``R[r·(W−1) + c + off]`` of a flat tensor, W = 4·band wide and
off = 2·band − 1, so every c − r in [−(2·band − 1), 2·band] has a slot of
its own. The twin's ribbon is 3·band wide and relies on a row wrap for
the widest in-flight span; the 4·band width of the Pallas kernels needs
none. A task's block is then a plain strided view (row stride W − 1),
updated in place. The kernels use the same layout.

Real dtypes only: the twin's complex branch (phase rotations, the
column-0 phase of tb2bd) is not ported, and a complex input raises.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from .precision import full_f32_matmul


def max_chase(n: int, band: int) -> int:
    """Reflectors in sweep 0, the most of any sweep."""
    return (n - 2) // band + 1 if n >= 2 else 0


def reflector_span(n: int, s: int, t: int, band: int) -> tuple[int, int]:
    """(start, length) of reflector (sweep s, chase t) in the shared
    packing — hb2st rows, tb2bd U-side rows, tb2bd V-side columns."""
    start = s + 1 + t * band
    return start, min(band, n - start)


def larfg(x: torch.Tensor):
    """LAPACK-style real Householder generator: ``(v, tau, beta)`` with
    (I − tau·v·vᵀ)·x = beta·e₀, v[0] = 1, beta = −sign(x₀)·‖x‖ with
    sign(0) = +1; tau = 0 and beta = x₀ when ‖x[1:]‖ = 0. Tensor ops
    only, so no host round trip on the card."""
    alpha = x[0]
    xnorm2 = (x[1:] * x[1:]).sum()
    trivial = xnorm2 == 0
    sgn = torch.where(alpha < 0, -1.0, 1.0).to(x.dtype)
    beta = torch.where(trivial, alpha,
                       -sgn * torch.sqrt(alpha * alpha + xnorm2))
    tau = torch.where(trivial, 0.0, (beta - alpha) / beta).to(x.dtype)
    vden = torch.where(trivial, 1.0, alpha - beta).to(x.dtype)
    v = x / vden
    v[0] = 1.0
    return v, tau, beta


# ---------------------------------------------------------------------------
# the ribbon
# ---------------------------------------------------------------------------

def ribbon_layout(band: int) -> tuple[int, int]:
    """(W, off) of the ribbon for ``band``."""
    return 4 * band, 2 * band - 1


def ribbon(ab: torch.Tensor, upper: bool) -> torch.Tensor:
    """The flat ribbon holding a compact band: lower storage
    ``ab[d, j] = A[j+d, j]`` mirrored into both triangles (hb2st), or
    upper storage ``ab[d, j] = A[j, j+d]`` alone (tb2bd); n·W entries."""
    b, n = ab.shape[0] - 1, ab.shape[1]
    W, off = ribbon_layout(b)
    rib = ab.new_zeros(n * W)
    d = torch.arange(b + 1, device=ab.device)[:, None]
    j = torch.arange(n, device=ab.device)[None, :]
    keep = (j < n - d).expand(b + 1, n)
    vals = ab[keep]
    if upper:
        rib[(j * (W - 1) + j + d + off).expand(b + 1, n)[keep]] = vals
    else:
        rib[((j + d) * (W - 1) + j + off).expand(b + 1, n)[keep]] = vals
        rib[(j * (W - 1) + j + d + off).expand(b + 1, n)[keep]] = vals
    return rib


def ribbon_diagonals(rib: torch.Tensor, n: int, band: int,
                     upper: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(d, e) read back from the ribbon: the diagonal and the sub-
    (hb2st) or super-diagonal (tb2bd)."""
    W, off = ribbon_layout(band)
    j = torch.arange(n, device=rib.device)
    d = rib[j * W + off]
    k = j[:-1]
    e = rib[k * W + off + 1] if upper else rib[(k + 1) * (W - 1) + k + off]
    return d, e


def _block(rib: torch.Tensor, band: int, r0: int, nr: int, c0: int,
           nc: int) -> torch.Tensor:
    """Writable view of A[r0:r0+nr, c0:c0+nc] in the ribbon."""
    W, off = ribbon_layout(band)
    return torch.as_strided(rib, (nr, nc), (W - 1, 1),
                            r0 * (W - 1) + c0 + off)


def _apply_left(v, tau, B):
    """B ← (I − tau·v·vᵀ)·B in place."""
    w = v @ B
    B.sub_(torch.outer(tau * v, w))


def _apply_right(v, tau, B):
    """B ← B·(I − tau·v·vᵀ) in place."""
    w = B @ v
    B.sub_(torch.outer(tau * w, v))


def _apply_two_sided(v, tau, D):
    """D ← (I − tau·v·vᵀ)·D·(I − tau·v·vᵀ) in place for a symmetric D, as
    one matvec and one symmetric rank-2 update (the form of the hb2st
    kernel, csrc/hb2st_chase.cu): y = tau·D·v, w = y − (tau/2)·(vᵀy)·v,
    D −= v·wᵀ + w·vᵀ. D stays exactly symmetric."""
    y = tau * (D @ v)
    alpha = (-0.5 * tau) * (v @ y)
    w = y + alpha * v
    D.sub_(torch.outer(v, w) + torch.outer(w, v))


def _check_real(name: str, t: torch.Tensor) -> None:
    slate_error_if(t.dtype.is_complex,
                   f"{name}: complex bands are not ported yet (got "
                   f"{t.dtype}); the two-stage path runs real dtypes only")


# ---------------------------------------------------------------------------
# hb2st
# ---------------------------------------------------------------------------

def hb2st(ab: torch.Tensor):
    """Symmetric band (lower storage ``ab[d, j] = A[j+d, j]``,
    d = 0..band) → tridiagonal by bulge chasing, task by task.

    Returns ``(d, e, V, tau)``: d [n], e [n−1]; V [S, T, band] and
    tau [S, T] (S = n − 1, T = :func:`max_chase`) pack the reflectors,
    A = Q·T·Qᵀ with Q = H₁ᵀ·H₂ᵀ⋯ in task order (apply with
    ``linalg.bulge.apply_bulge_reflectors``). Band < 1 or n < 2 is the
    trivial case: the band's own diagonals and empty packs."""
    _check_real("hb2st", ab)
    band, n = ab.shape[0] - 1, ab.shape[1]
    if band < 1 or n < 2:
        e = ab[1, :n - 1] if band >= 1 else ab.new_zeros(max(n - 1, 0))
        return (ab[0].clone(), e.clone(),
                ab.new_zeros((0, 0, max(band, 1))), ab.new_zeros((0, 0)))
    S, T = n - 1, max_chase(n, band)
    V = ab.new_zeros((S, T, band))
    tau = ab.new_zeros((S, T))
    rib = ribbon(ab, upper=False)
    blk = lambda r0, nr, c0, nc: _block(rib, band, r0, nr, c0, nc)  # noqa: E731
    with full_f32_matmul():
        for s in range(S):
            # task 0: annihilate column s below the subdiagonal
            r0, L = reflector_span(n, s, 0, band)
            col = blk(r0, L, s, 1)[:, 0]
            row = blk(s, 1, r0, L)[0]
            v, tv, beta = larfg(col.clone())
            V[s, 0, :L] = v
            tau[s, 0] = tv
            col.zero_()
            col[0] = beta
            row.zero_()
            row[0] = beta
            _apply_two_sided(v, tv, blk(r0, L, r0, L))
            # chase the bulge down the band
            for t in range(1, T):
                i0, L2 = reflector_span(n, s, t, band)
                if i0 > n - 1:
                    break
                j0, L1 = reflector_span(n, s, t - 1, band)
                B = blk(i0, L2, j0, L1)
                _apply_right(V[s, t - 1, :L1], tau[s, t - 1], B)
                v, tv, beta = larfg(B[:, 0].clone())
                V[s, t, :L2] = v
                tau[s, t] = tv
                B[:, 0] = 0.0
                B[0, 0] = beta
                _apply_left(v, tv, B[:, 1:])
                blk(j0, L1, i0, L2).copy_(B.mT)      # the mirror
                _apply_two_sided(v, tv, blk(i0, L2, i0, L2))
    d, e = ribbon_diagonals(rib, n, band, upper=False)
    return d, e, V, tau


# ---------------------------------------------------------------------------
# tb2bd
# ---------------------------------------------------------------------------

def _gebr_diag(rib, band, c0, L1, v, tv):
    """The diagonal block's half of a tb2bd task: right-apply the task's
    V-side reflector, then the U-side reflector from its column 0."""
    D = _block(rib, band, c0, L1, c0, L1)
    _apply_right(v, tv, D)
    u, tu, beta = larfg(D[:, 0].clone())
    D[:, 0] = 0.0
    D[0, 0] = beta
    _apply_left(u, tu, D[:, 1:])
    return u, tu


def tb2bd(ub: torch.Tensor):
    """Upper triangular band (``ub[d, j] = A[j, j+d]``, d = 0..band) →
    upper bidiagonal by bulge chasing, task by task.

    Returns ``(d, e, Vu, tauu, Vv, tauv, phase0)``: d [n], e [n−1] the
    diagonal and superdiagonal; (Vu, tauu) the U-side (row) reflectors
    and (Vv, tauv) the V-side (column) reflectors in the shared
    (sweep, chase) packing; phase0 = 1 (real input: column 0 needs no
    phase). A_band = U₂·B·V₂ᵀ with U₂, V₂ the H₁ᵀ·H₂ᵀ⋯ products."""
    _check_real("tb2bd", ub)
    band, n = ub.shape[0] - 1, ub.shape[1]
    phase0 = ub.new_ones(())
    if band < 1 or n <= 1:
        e = ub[1, :n - 1] if band >= 1 else ub.new_zeros(max(n - 1, 0))
        z3, z2 = ub.new_zeros((0, 0, max(band, 1))), ub.new_zeros((0, 0))
        return (ub[0].clone(), e.clone(), z3, z2, z3.clone(), z2.clone(),
                phase0)
    S, T = n - 1, max_chase(n, band)
    Vu, Vv = ub.new_zeros((S, T, band)), ub.new_zeros((S, T, band))
    tauu, tauv = ub.new_zeros((S, T)), ub.new_zeros((S, T))
    rib = ribbon(ub, upper=True)
    blk = lambda r0, nr, c0, nc: _block(rib, band, r0, nr, c0, nc)  # noqa: E731
    with full_f32_matmul():
        for s in range(S):
            # task 0: the V-side reflector from row s, then the block
            # below it (rows s+1.., the diagonal block at c0 = s+1)
            c0, L1 = reflector_span(n, s, 0, band)
            row = blk(s, 1, c0, L1)[0]
            v, tv, beta = larfg(row.clone())
            Vv[s, 0, :L1], tauv[s, 0] = v, tv
            row.zero_()
            row[0] = beta
            Vu[s, 0, :L1], tauu[s, 0] = _gebr_diag(rib, band, c0, L1, v, tv)
            for t in range(1, T):
                c0, L1 = reflector_span(n, s, t, band)
                if c0 > n - 1:
                    break
                r0, Lp = reflector_span(n, s, t - 1, band)
                B = blk(r0, Lp, c0, L1)
                # the previous U-side reflector makes the fill
                _apply_left(Vu[s, t - 1, :Lp], tauu[s, t - 1], B)
                v, tv, beta = larfg(B[0, :].clone())
                Vv[s, t, :L1], tauv[s, t] = v, tv
                B[0, :] = 0.0
                B[0, 0] = beta
                _apply_right(v, tv, B[1:, :])
                Vu[s, t, :L1], tauu[s, t] = _gebr_diag(rib, band, c0, L1,
                                                       v, tv)
    d, e = ribbon_diagonals(rib, n, band, upper=True)
    return d, e, Vu, tauu, Vv, tauv, phase0


# ---------------------------------------------------------------------------
# reference application of the packed reflectors (tests)
# ---------------------------------------------------------------------------

def apply_packed(V, tau, Z, band, forward):
    """Apply the packed reflector product to the rows of Z in place,
    one reflector at a time (the twin's ``apply_packed``, real):
    forward=True gives Z ← H_K·(…(H_1·Z)), forward=False
    H_1·(…(H_K·Z)), K in (sweep, chase) order."""
    S, n = V.shape[0], Z.shape[0]
    for s in (range(S) if forward else range(S - 1, -1, -1)):
        for t in range(V.shape[1]):
            start, L = reflector_span(n, s, t, band)
            if start > n - 1:
                break
            _apply_left(V[s, t, :L], tau[s, t], Z[start:start + L])
    return Z
