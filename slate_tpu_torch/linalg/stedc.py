"""Divide & conquer symmetric tridiagonal eigensolver (reference
src/stedc.cc and stedc_{sort,deflate,secular,solve,merge,z_vector}.cc,
after LAPACK dlaed0-4 and Gu–Eisenstat; counterpart of
``slate_tpu/linalg/stedc.py``).

The port's own copy of the host parts: the secular-equation solve, the
deflation walk and the Gu–Eisenstat z-vector, all O(k) memory per merge
in numpy. The eigenvectors live on the device when one is given: Z is a
torch tensor there, each merge's orthogonal factor G is assembled there
from the O(k) host data, and the merge is one product Z[lo:hi, lo:hi]·G.
The host never holds a k×k matrix on that path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..internal.precision import full_f32_matmul

_EPS = np.finfo(np.float64).eps


# ---------------------------------------------------------------------------
# secular equation (reference stedc_secular.cc / dlaed4)
# ---------------------------------------------------------------------------

def _secular(dd, zz, rho, iters=64, chunk=128):
    """Roots of 1 + rho·Σ zᵢ²/(dᵢ − λ) = 0 for ascending dd, rho > 0.

    Returns (base, off) with λⱼ = dd[baseⱼ] + offⱼ, the shift taken from
    the closer pole (dlaed4's convention), so dᵢ − λⱼ keeps full relative
    precision; bisection on the monotone shifted g, then a pole solve
    that recovers tiny-z roots to full relative precision. The roots are
    solved ``chunk`` at a time; each root's arithmetic does not depend
    on the chunk, and [k, 128] temporaries stay in cache where the JAX
    package's [k, 2048] ones do not."""
    k = dd.shape[0]
    z2 = zz * zz
    gaps = np.empty(k)
    gaps[:-1] = np.diff(dd)
    gaps[-1] = rho * z2.sum()
    base = np.arange(k)
    off = np.empty(k)
    for j0 in range(0, k, chunk):
        j1 = min(j0 + chunk, k)
        cols = np.arange(j0, j1)
        gp = gaps[cols]
        deltaL = dd[:, None] - dd[None, cols]
        gm = 1.0 + rho * np.sum(z2[:, None] / (deltaL - 0.5 * gp[None, :]),
                                axis=0)
        right = (gm < 0) & (cols < k - 1)
        widen = (gm < 0) & (cols == k - 1)
        base[j0:j1] = np.where(right, cols + 1, cols)
        delta = dd[:, None] - dd[base[j0:j1]][None, :]
        lo = np.where(right, -0.5 * gp, np.where(widen, 0.5 * gp, 0.0))
        hi = np.where(right, 0.0, np.where(widen, gp, 0.5 * gp))
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            g = 1.0 + rho * np.sum(z2[:, None] / (delta - mid[None, :]),
                                   axis=0)
            pos = g > 0
            hi = np.where(pos, mid, hi)
            lo = np.where(pos, lo, mid)
        ofj = 0.5 * (lo + hi)
        zp = z2[base[j0:j1]]
        pole = np.arange(k)[:, None] == base[j0:j1][None, :]
        zsafe = np.where(pole, 0.0, z2[:, None])
        with np.errstate(divide="ignore", invalid="ignore"):
            for _ in range(3):
                Ps = 1.0 + rho * np.sum(zsafe / (delta - ofj[None, :]),
                                        axis=0)
                cand = rho * zp / Ps
                ofj = np.clip(np.where(np.isfinite(cand), cand, ofj), lo, hi)
        off[j0:j1] = ofj
    return base, off


def _z_vector(dd, base, off, zz, rho, chunk=2048):
    """Gu–Eisenstat recomputed ẑ (reference stedc_z_vector.cc):
    ẑᵢ² = (1/rho)·Πⱼ(λⱼ − dᵢ) / Π_{j≠i}(dⱼ − dᵢ), with the sign of zz."""
    k = dd.shape[0]
    db = dd[base]
    zhat2 = np.empty(k)
    for i0 in range(0, k, chunk):
        i1 = min(i0 + chunk, k)
        rows = np.arange(i0, i1)
        num = (db[None, :] - dd[rows, None]) + off[None, :]
        den = dd[None, :] - dd[rows, None]
        loc = np.arange(i1 - i0)
        den_safe = den.copy()
        den_safe[loc, rows] = 1.0
        ratio = num / den_safe
        ratio[loc, rows] = num[loc, rows]
        zhat2[i0:i1] = np.prod(ratio, axis=1) / rho
    return np.sign(zz) * np.sqrt(np.maximum(zhat2, 0.0))


# ---------------------------------------------------------------------------
# deflation (reference stedc_deflate.cc / dlaed2)
# ---------------------------------------------------------------------------

class _MergeSpec:
    """Host-side O(k) description of one merge's orthogonal factor."""
    __slots__ = ("order", "rots", "uidx", "fidx", "dd", "base", "off",
                 "zhat", "col_sort", "vals")


def _merge_spec(D, z, rho):
    """Deflation walk and secular solve; D, z in child-concat order."""
    spec = _MergeSpec()
    k = D.shape[0]
    order = np.argsort(D, kind="stable")
    Ds = D[order]
    zs = z[order].copy()
    zmax = np.abs(zs).max() if k else 0.0
    dmax = np.abs(Ds).max() if k else 0.0
    tol = 8.0 * _EPS * max(dmax, zmax)
    rots = []
    deflated = np.zeros(k, bool)
    surv = -1
    for j in range(k):
        if rho * abs(zs[j]) <= tol:
            deflated[j] = True
            continue
        if surv >= 0:
            r = np.hypot(zs[surv], zs[j])
            c, s = zs[surv] / r, zs[j] / r
            if abs((Ds[j] - Ds[surv]) * c * s) <= tol:
                # Givens on (surv, j) zeroes z_j; the rotated 2×2
                # diagonal is kept, its ≤ tol off-diagonal dropped
                rots.append((surv, j, c, s))
                zs[surv], zs[j] = r, 0.0
                t = c * c * Ds[surv] + s * s * Ds[j]
                Ds[j] = s * s * Ds[surv] + c * c * Ds[j]
                Ds[surv] = t
                deflated[j] = True
                continue
        surv = j
    uidx = np.where(~deflated)[0]
    fidx = np.where(deflated)[0]
    spec.order, spec.rots, spec.uidx, spec.fidx = order, rots, uidx, fidx
    if uidx.size:
        dd = Ds[uidx]
        zz = zs[uidx]
        base, off = _secular(dd, zz, rho)
        zhat = _z_vector(dd, base, off, zz, rho)
        lam_u = dd[base] + off
    else:
        dd = off = zhat = np.zeros(0)
        base = np.zeros(0, int)
        lam_u = np.zeros(0)
    spec.dd, spec.base, spec.off, spec.zhat = dd, base, off, zhat
    vals = np.concatenate([lam_u, Ds[fidx]])
    spec.col_sort = np.argsort(vals, kind="stable")
    spec.vals = vals[spec.col_sort]
    return spec


def _trivial_sort_spec(D):
    """rho == 0: the children are independent; the merge is a sort."""
    spec = _MergeSpec()
    k = D.shape[0]
    spec.order = np.argsort(D, kind="stable")
    spec.rots = []
    spec.uidx = np.zeros(0, int)
    spec.fidx = np.arange(k)
    spec.dd = spec.off = spec.zhat = np.zeros(0)
    spec.base = np.zeros(0, int)
    spec.col_sort = np.arange(k)
    spec.vals = D[spec.order]
    return spec


def assemble_g(spec, k: int, device=None, dtype=torch.float64):
    """The k×k orthogonal merge factor G = P₁·R·[secular | unit]·P₂ in
    child-concat row order, as a tensor on ``device`` (numpy's host
    memory is never k×k): the secular columns ẑᵢ/(dᵢ − λⱼ), normalised,
    the deflated unit columns, the deflation rotations, the sorts."""
    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)
    k1 = spec.uidx.size
    G = torch.zeros((k, k), dtype=torch.float64, device=device)
    if k1:
        dd, db = t(spec.dd), t(spec.dd[spec.base])
        cols = t(spec.zhat)[:, None] / ((dd[:, None] - db[None, :])
                                        - t(spec.off)[None, :])
        G[t(spec.uidx)[:, None], torch.arange(k1, device=device)[None, :]] = (
            cols / torch.linalg.vector_norm(cols, dim=0, keepdim=True))
    if spec.fidx.size:
        G[t(spec.fidx), t(k1 + np.arange(spec.fidx.size))] = 1.0
    # rotations: Z·R₁·R₂⋯ ⇒ left-multiply G by R_m ⋯ R₁
    for (i, j, c, s) in reversed(spec.rots):
        gi, gj = G[i].clone(), G[j].clone()
        G[i] = c * gi - s * gj
        G[j] = s * gi + c * gj
    G = G[:, t(spec.col_sort)]
    out = torch.empty_like(G)
    out[t(spec.order)] = G
    return out.to(dtype)


# ---------------------------------------------------------------------------
# recursion (reference stedc.cc / dlaed0)
# ---------------------------------------------------------------------------

def _stedc_rec(d, e, lo, hi, leaf_fn, zrow_fn, apply_fn, nmin):
    n = hi - lo
    if n <= nmin:
        return leaf_fn(d[lo:hi].copy(), e[lo:hi - 1].copy(), lo, hi)
    mid = lo + n // 2
    rho = e[mid - 1]
    if rho == 0.0:
        v1 = _stedc_rec(d, e, lo, mid, leaf_fn, zrow_fn, apply_fn, nmin)
        v2 = _stedc_rec(d, e, mid, hi, leaf_fn, zrow_fn, apply_fn, nmin)
        spec = _trivial_sort_spec(np.concatenate([v1, v2]))
        apply_fn(lo, hi, spec)
        return spec.vals
    arho = abs(rho)
    sgn = 1.0 if rho > 0 else -1.0
    # rank-one tear: T = blockdiag + |rho|·v·vᵀ, v = [e_last; sgn·e_first]
    d[mid - 1] -= arho
    d[mid] -= arho
    v1 = _stedc_rec(d, e, lo, mid, leaf_fn, zrow_fn, apply_fn, nmin)
    v2 = _stedc_rec(d, e, mid, hi, leaf_fn, zrow_fn, apply_fn, nmin)
    D = np.concatenate([v1, v2])
    z = np.concatenate([zrow_fn(mid - 1, lo, mid), sgn * zrow_fn(mid, mid, hi)])
    spec = _merge_spec(D, z, arho)
    apply_fn(lo, hi, spec)
    return spec.vals


def stedc(d, e, want_vectors: bool = True, device=None, dtype=None,
          nmin: int = 48):
    """Eigendecomposition of the symmetric tridiagonal (d, e) by divide
    & conquer: ``(lam ascending, Z | None)``, lam a float64 numpy array.

    With ``device``, Z is a torch tensor accumulated on that device in
    ``dtype`` (float64 by default); the host keeps O(n) memory. Without
    one, Z is a float64 numpy array on the host."""
    from scipy.linalg import eigh_tridiagonal, eigvalsh_tridiagonal
    d = np.asarray(torch.as_tensor(d).cpu(), np.float64).copy()
    e = np.asarray(torch.as_tensor(e).cpu(), np.float64).copy()
    n = d.shape[0]
    if n == 0:
        return np.zeros(0), None
    if not want_vectors:
        return eigvalsh_tridiagonal(d, e), None
    if n <= nmin:
        lam, Z = eigh_tridiagonal(d, e)
        if device is not None:
            Z = torch.as_tensor(Z, device=device).to(dtype or torch.float64)
        return lam, Z

    if device is None:
        Zh = np.zeros((n, n))

        def leaf_fn(dl, el, lo, hi):
            lam, q = eigh_tridiagonal(dl, el)
            Zh[lo:hi, lo:hi] = q
            return lam

        def zrow_fn(row, c0, c1):
            return Zh[row, c0:c1].copy()

        def apply_fn(lo, hi, spec):
            G = assemble_g(spec, hi - lo).numpy()
            Zh[lo:hi, lo:hi] = Zh[lo:hi, lo:hi] @ G

        return _stedc_rec(d, e, 0, n, leaf_fn, zrow_fn, apply_fn, nmin), Zh

    zdt = dtype or torch.float64
    Z = torch.zeros((n, n), dtype=zdt, device=device)

    def leaf_fn(dl, el, lo, hi):
        lam, q = eigh_tridiagonal(dl, el)
        Z[lo:hi, lo:hi] = torch.as_tensor(q, device=device).to(zdt)
        return lam

    def zrow_fn(row, c0, c1):
        return Z[row, c0:c1].to("cpu", torch.float64).numpy()

    def apply_fn(lo, hi, spec):
        G = assemble_g(spec, hi - lo, device, zdt)
        with full_f32_matmul():
            Z[lo:hi, lo:hi] = Z[lo:hi, lo:hi] @ G

    lam = _stedc_rec(d, e, 0, n, leaf_fn, zrow_fn, apply_fn, nmin)
    return lam, Z
