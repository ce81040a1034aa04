"""Band bulge chasing in plain PyTorch: hb2st (Hermitian band → real
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

Complex bands follow the twin's complex branch: ``larfg``'s β is real
(a length-1 complex column is a pure phase rotation), so d and e come
out real with no extra phase pass; tb2bd's d[0], which no reflector
touches, is made real by the recorded column-0 phase (:func:`phase0`).
A Hermitian band's diagonal is read by its real part. d and e are of
the band's real dtype.
"""

from __future__ import annotations

import torch

from .precision import full_f32_matmul


def max_chase(n: int, band: int) -> int:
    """Reflectors in sweep 0, the most of any sweep."""
    return (n - 2) // band + 1 if n >= 2 else 0


def reflector_span(n: int, s: int, t: int, band: int) -> tuple[int, int]:
    """(start, length) of reflector (sweep s, chase t) in the shared
    packing — hb2st rows, tb2bd U-side rows, tb2bd V-side columns."""
    start = s + 1 + t * band
    return start, min(band, n - start)


def _cdiv(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x / d for a complex 0-dim d, d scaled by its largest part first (the
    kernels' ``quot``): torch's own complex division overflows for a
    subnormal d."""
    s = torch.maximum(d.real.abs(), d.imag.abs())
    dr, di = d.real / s, d.imag / s
    den = (dr * dr + di * di) * s
    return torch.complex((x.real * dr + x.imag * di) / den,
                         (x.imag * dr - x.real * di) / den)


# below this |alpha|^2 + ||x[1:]||^2 of a complex larfg may have lost
# squares to underflow (TINY_NORM2 in csrc/chase_flow.cuh)
TINY_NORM2 = {torch.complex64: 2.0 ** -100, torch.complex128: 2.0 ** -900}


def larfg(x: torch.Tensor):
    """LAPACK-style Householder generator: ``(v, tau, beta)`` with
    (I − tau·v·vᴴ)·x = beta·e₀, v[0] = 1 and beta real:
    beta = −sign(Re x₀)·‖x‖ with sign(0) = +1, tau = (beta − conj x₀)/beta;
    tau = 0 and beta = x₀ when ‖x[1:]‖ = 0 and x₀ is real (a complex x₀
    alone is a phase rotation). Tensor ops only, so no host round trip
    on the card."""
    alpha = x[0]
    if x.is_complex():
        xnorm2 = (x[1:].real ** 2 + x[1:].imag ** 2).sum()
        ar, ai = alpha.real, alpha.imag
        trivial = (xnorm2 == 0) & (ai == 0)
        sgn = torch.where(ar < 0, -1.0, 1.0).to(ar.dtype)
        sq = ar * ar + ai * ai + xnorm2
        # a tiny x (a phase rotation of a tiny alpha, say) loses its
        # squares to underflow: below TINY_NORM2 its norm is taken from x
        # scaled by its largest part, as the kernels do (rescue_norm in
        # csrc/chase_flow.cuh); without it beta is 0 and tau infinite
        big = torch.maximum(x.real.abs(), x.imag.abs()).max()
        sc = torch.where(big > 0, big, 1.0)
        rescued = big * torch.sqrt(((x.real / sc) ** 2
                                    + (x.imag / sc) ** 2).sum())
        nrm = torch.where(sq < TINY_NORM2[x.dtype], rescued, torch.sqrt(sq))
        beta = torch.where(trivial, ar, -sgn * nrm)
        tau = torch.where(trivial, 0.0,
                          torch.complex((beta - ar) / beta, ai / beta))
        vden = torch.where(trivial, 1.0, alpha - beta)
        v = _cdiv(x, vden)
        v[0] = 1.0
        return v, tau, beta
    else:
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
    ``ab[d, j] = A[j+d, j]`` of a Hermitian band mirrored into both
    triangles, the upper one conjugated and the diagonal real (hb2st), or
    upper storage ``ab[d, j] = A[j, j+d]`` alone (tb2bd); n·W entries."""
    b, n = ab.shape[0] - 1, ab.shape[1]
    W, off = ribbon_layout(b)
    rib = ab.new_zeros(n * W)
    d = torch.arange(b + 1, device=ab.device)[:, None]
    j = torch.arange(n, device=ab.device)[None, :]
    keep = (j < n - d).expand(b + 1, n)
    if not upper and ab.is_complex():
        ab = torch.cat([ab[:1].real.to(ab.dtype), ab[1:]])
    vals = ab[keep]
    if upper:
        rib[(j * (W - 1) + j + d + off).expand(b + 1, n)[keep]] = vals
    else:
        rib[((j + d) * (W - 1) + j + off).expand(b + 1, n)[keep]] = vals
        rib[(j * (W - 1) + j + d + off).expand(b + 1, n)[keep]] = vals.conj()
    return rib


def ribbon_diagonals(rib: torch.Tensor, n: int, band: int,
                     upper: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(d, e) read back from the ribbon: the diagonal and the sub-
    (hb2st) or super-diagonal (tb2bd), in the real dtype (a complex
    chase leaves them real)."""
    W, off = ribbon_layout(band)
    j = torch.arange(n, device=rib.device)
    d = rib[j * W + off]
    k = j[:-1]
    e = rib[k * W + off + 1] if upper else rib[(k + 1) * (W - 1) + k + off]
    return (d.real.clone(), e.real.clone()) if rib.is_complex() else (d, e)


def phase0(rib: torch.Tensor, band: int) -> torch.Tensor:
    """tb2bd's column-0 phase (the twin's ``band_bulge.py:239-249``), on
    the ribbon in place: for a complex a₀₀ that is nonzero with a nonzero
    imaginary part, phase0 = conj(a₀₀)/|a₀₀| and a₀₀ ← |a₀₀|; else 1 (a
    negative real a₀₀ stays). A 0-dim tensor of the ribbon's dtype, by
    tensor ops (no host round trip)."""
    return _phase_at(rib, ribbon_layout(band)[1])


def _phase_at(x: torch.Tensor, i: int) -> torch.Tensor:
    """:func:`phase0` of the element x[i], made real in place."""
    one = x.new_ones(())
    if not x.is_complex():
        return one
    a00 = x[i]
    mag = a00.abs()
    cplx = (a00 != 0) & (a00.imag != 0)
    ph = torch.where(cplx, a00.conj() / torch.where(cplx, mag, 1.0), one)
    x[i] = torch.where(cplx, mag.to(x.dtype), a00)
    return ph


def _block(rib: torch.Tensor, band: int, r0: int, nr: int, c0: int,
           nc: int) -> torch.Tensor:
    """Writable view of A[r0:r0+nr, c0:c0+nc] in the ribbon."""
    W, off = ribbon_layout(band)
    return torch.as_strided(rib, (nr, nc), (W - 1, 1),
                            r0 * (W - 1) + c0 + off)


def _apply_left(v, tau, B):
    """B ← (I − tau·v·vᴴ)·B in place."""
    w = v.conj() @ B
    B.sub_(torch.outer(tau * v, w))


def _apply_right(v, tau, B):
    """B ← B·(I − tau·v·vᴴ)ᴴ in place (the twin's ``_apply_right_h``)."""
    w = B @ v
    B.sub_(torch.outer(tau.conj() * w, v.conj()))


def _apply_two_sided(v, tau, D):
    """D ← H·D·Hᴴ, H = I − tau·v·vᴴ, in place for a Hermitian D, as one
    matvec and one Hermitian rank-2 update (the form of the hb2st kernel,
    csrc/hb2st_chase.cu): y = conj(tau)·D·v, w = y − (tau/2)·(vᴴy)·v,
    D −= v·wᴴ + w·vᴴ. In real arithmetic D stays exactly symmetric."""
    y = tau.conj() * (D @ v)
    alpha = (-0.5 * tau) * (v.conj() @ y)
    w = y + alpha * v
    D.sub_(torch.outer(v, w.conj()) + torch.outer(w, v.conj()))


# ---------------------------------------------------------------------------
# hb2st
# ---------------------------------------------------------------------------

def _conj_copy(x: torch.Tensor) -> torch.Tensor:
    """A new tensor holding conj(x) (x itself copied when real)."""
    return x.conj().resolve_conj() if x.is_complex() else x.clone()


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.real.clone() if x.is_complex() else x.clone()


def hb2st(ab: torch.Tensor):
    """Hermitian band (lower storage ``ab[d, j] = A[j+d, j]``,
    d = 0..band; the diagonal read by its real part) → real tridiagonal
    by bulge chasing, task by task.

    Returns ``(d, e, V, tau)``: d [n], e [n−1] of the real dtype; V
    [S, T, band] and tau [S, T] (S = n − 1, T = :func:`max_chase`) pack
    the reflectors, A = Q·T·Qᴴ with Q = H₁ᴴ·H₂ᴴ⋯ in task order (apply
    with ``linalg.bulge.apply_bulge_reflectors``). Band < 1 or n < 2 is
    the trivial case: the band's own diagonals (real parts) and empty
    packs."""
    band, n = ab.shape[0] - 1, ab.shape[1]
    if band < 1 or n < 2:
        e = ab[1, :n - 1] if band >= 1 else ab.new_zeros(max(n - 1, 0))
        return (_real(ab[0]), _real(e),
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
                blk(j0, L1, i0, L2).copy_(B.mH)      # the mirror
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
    diagonal and superdiagonal, of the real dtype; (Vu, tauu) the U-side
    (row) reflectors and (Vv, tauv) the V-side (column) reflectors in the
    shared (sweep, chase) packing; phase0 the column-0 phase
    (:func:`phase0`, 1 for a real band). A_band·diag(phase0, 1, …) =
    U₂·B·V₂ᴴ with U₂, V₂ the H₁ᴴ·H₂ᴴ⋯ products."""
    band, n = ub.shape[0] - 1, ub.shape[1]
    if band < 1 or n <= 1:
        e = ub[1, :n - 1] if band >= 1 else ub.new_zeros(max(n - 1, 0))
        z3, z2 = ub.new_zeros((0, 0, max(band, 1))), ub.new_zeros((0, 0))
        d = ub[0].clone()
        ph = _phase_at(d, 0) if n >= 1 else ub.new_ones(())
        return (_real(d), _real(e), z3, z2, z3.clone(), z2.clone(), ph)
    S, T = n - 1, max_chase(n, band)
    Vu, Vv = ub.new_zeros((S, T, band)), ub.new_zeros((S, T, band))
    tauu, tauv = ub.new_zeros((S, T)), ub.new_zeros((S, T))
    rib = ribbon(ub, upper=True)
    ph = phase0(rib, band)
    blk = lambda r0, nr, c0, nc: _block(rib, band, r0, nr, c0, nc)  # noqa: E731
    with full_f32_matmul():
        for s in range(S):
            # task 0: the V-side reflector from row s, then the block
            # below it (rows s+1.., the diagonal block at c0 = s+1)
            c0, L1 = reflector_span(n, s, 0, band)
            row = blk(s, 1, c0, L1)[0]
            v, tv, beta = larfg(_conj_copy(row))
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
                v, tv, beta = larfg(_conj_copy(B[0, :]))
                Vv[s, t, :L1], tauv[s, t] = v, tv
                B[0, :] = 0.0
                B[0, 0] = beta
                _apply_right(v, tv, B[1:, :])
                Vu[s, t, :L1], tauu[s, t] = _gebr_diag(rib, band, c0, L1,
                                                       v, tv)
    d, e = ribbon_diagonals(rib, n, band, upper=True)
    return d, e, Vu, tauu, Vv, tauv, ph


# ---------------------------------------------------------------------------
# reference application of the packed reflectors (tests)
# ---------------------------------------------------------------------------

def apply_packed(V, tau, Z, band, forward, conj_tau=False):
    """Apply the packed reflector product to the rows of Z in place,
    one reflector at a time (the twin's ``apply_packed``):
    forward=True gives Z ← H_K·(…(H_1·Z)), forward=False
    H_1·(…(H_K·Z)), K in (sweep, chase) order; ``conj_tau`` applies
    Hᴴ = I − conj(tau)·v·vᴴ in place of each H."""
    S, n = V.shape[0], Z.shape[0]
    for s in (range(S) if forward else range(S - 1, -1, -1)):
        for t in range(V.shape[1]):
            start, L = reflector_span(n, s, t, band)
            if start > n - 1:
                break
            tv = tau[s, t].conj() if conj_tau else tau[s, t]
            _apply_left(V[s, t, :L], tv, Z[start:start + L])
    return Z
