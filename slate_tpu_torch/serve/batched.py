"""Batched drivers: factorizations and solves over a leading batch axis
(the port's copy of ``slate_tpu/serve/batched.py``).

Serving traffic is many small and medium solves. These drivers keep each
problem whole on one device and run the members of a ``[batch, n, n]``
stack side by side, one op a step for the whole stack, where the JAX
package ``vmap``s its single-matrix dense core:

* the Cholesky core is the stack form of the one-rank dense loop
  (``linalg/potrf._potrf_dense_loop``): each diagonal block of the whole
  stack by one K1 launch (float32 on the card, where the capability
  table admits nb; ``torch.linalg.cholesky_ex`` over the stack for the
  other types, as ``tile_potrf`` routes), the panel by one batched
  ``solve_triangular`` (the JAX body's XLA ``triangular_solve``) and the
  trailing update at the request's precision tier;
* the LU core follows the JAX ``_getrf_one``: each panel by a batched
  ``lu_factor_ex`` (XLA's ``lu``; a member with a zero pivot or a
  non-finite entry by LAPACK's unblocked loop, so the card's ``info``
  is the CPU's), every member's LAPACK pivots turned into its own row
  permutation, row gathers by index, the unit-lower solve and the
  trailing product at the tier; ``info`` counts the zero pivots and the
  poisoned panels.

Failure is per member: the finite guards take one ``info`` a member, a
failed member's factor is zero-filled where it went non-finite, and its
solve runs against a unit-substituted diagonal, so its X stays finite
(zero-filled) while its batchmates' results are those of a batch without
it.

Tensors stay on their device; a numpy stack goes to the CUDA card unless
the caller passes ``device="cpu"``, and without a card that raises. The
outputs are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..errors import SlateError
from ..internal.precision import (full_f32_matmul, resolve_tier,
                                  tier_context, tier_lhs, tier_mm, tier_rhs)
from ..internal.tile_kernels import _factor_dtype, hermitian_tile, tile_potrf
from ..linalg.getrf import _panel_getf2
from ..linalg.potrf import _syrk_update_inplace
from ..robust.guards import finite_guard, zero_nonfinite


def _check_stack(a, b=None):
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(
            f"batched driver expects a [batch, n, n] stack, got "
            f"{tuple(a.shape)}")
    if b is not None:
        if b.ndim != 3 or b.shape[0] != a.shape[0] or b.shape[1] != a.shape[1]:
            raise ValueError(
                f"rhs stack {tuple(b.shape)} does not match matrix stack "
                f"{tuple(a.shape)} (expected [batch, n, nrhs])")


def _resolve_nb(n: int, nb: int | None) -> int:
    from ..cache import buckets
    nb = nb or buckets.default_nb(n)
    nb = min(nb, n)
    if n % nb:
        raise ValueError(
            f"batched drivers need nb | n (bucket orders are tile "
            f"multiples); got n={n}, nb={nb}")
    return nb


def _as_stack(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is, a numpy array goes
    to ``device`` (the CUDA card when None)."""
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device).type != x.device.type:
            raise SlateError(f"a stack on {x.device} with device={device!r}:"
                             f" the batched drivers move no tensor")
        return x
    if device is None:
        if not torch.cuda.is_available():
            raise SlateError("the batched drivers put a numpy stack on the "
                             "CUDA card and none is available; pass "
                             "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _count(routine: str, a):
    obs.count("serve.batched_dispatch", routine=routine,
              bucket=str(a.shape[1]), b=str(a.shape[0]))


# ---------------------------------------------------------------------------
# cores over the stack
# ---------------------------------------------------------------------------

def _potrf_stack(a, nb, tier):
    """Blocked lower Cholesky of every member of a [batch, n, n] stack, the
    first-block ``info`` convention member by member. Returns ``(l, info
    [batch])``, l lower with the upper triangles zeroed."""
    a = a.clone()
    batch, n = a.shape[0], a.shape[1]
    info = torch.zeros(batch, dtype=torch.int32, device=a.device)
    fd = _factor_dtype(a.dtype)
    cplx = a.dtype.is_complex
    for k in range(n // nb):
        r0 = k * nb
        akk = hermitian_tile(a[:, r0:r0 + nb, r0:r0 + nb])
        lkk, info = finite_guard(tile_potrf(akk), info, k + 1, diag=True,
                                 cplx=cplx)
        a[:, r0:r0 + nb, r0:r0 + nb] = lkk.tril()
        if r0 + nb < n:
            with full_f32_matmul():
                pan = torch.linalg.solve_triangular(
                    lkk.to(fd).mH, a[:, r0 + nb:, r0:r0 + nb].to(fd),
                    upper=True, left=False).to(a.dtype)
            pan, info = finite_guard(pan, info, k + 1, cplx=cplx)
            a[:, r0 + nb:, r0:r0 + nb] = pan
            vl, vr = tier_lhs(pan, tier), tier_rhs(pan.mH, tier)
            with tier_context(tier, a.dtype):
                _syrk_update_inplace(a, r0 + nb, n - r0 - nb, vl, vr)
    return a.tril(), info


def _unit_substituted(t, lower: bool):
    """The triangle of each member with its zero diagonal entries (a
    guarded failure's zero fill) replaced by 1, so its solve stays
    finite; the member's nonzero ``info`` owns the report."""
    t = t.tril() if lower else t.triu()
    d = torch.diagonal(t, dim1=-2, dim2=-1)
    return t + torch.diag_embed((d == 0).to(t.dtype))


def _potrs_stack(l, b):
    fd = _factor_dtype(l.dtype)
    ls = _unit_substituted(l, True).to(fd)
    with full_f32_matmul():
        y = torch.linalg.solve_triangular(ls, b.to(fd), upper=False)
        x = torch.linalg.solve_triangular(ls.mH, y, upper=True)
    return zero_nonfinite(x.to(b.dtype))


def _perms_from_ipiv(piv: np.ndarray, rows: int, device) -> torch.Tensor:
    """Each member's row permutation ``perm [batch, rows]`` on ``device``
    (row i of the pivoted panel is row ``perm[i]`` of the panel) from
    LAPACK's 1-based ``piv [batch, r]`` on the host, the ``permutation``
    output of XLA's ``lu``. The swaps are composed on the host, one
    vectorised pass a column, as the port composes the other pivot lists
    (``runtime.resolve_pivots``)."""
    piv = np.clip(piv.astype(np.int64) - 1, 0, rows - 1)
    batch = piv.shape[0]
    perm = np.tile(np.arange(rows, dtype=np.int64), (batch, 1))
    members = np.arange(batch)
    for j in range(piv.shape[1]):
        p = piv[:, j]
        pj = perm[:, j].copy()
        perm[:, j] = perm[members, p]
        perm[members, p] = pj
    return torch.from_numpy(perm).to(device)


def _rows(x, perm):
    return torch.take_along_dim(x, perm[:, :, None], dim=1)


def _getrf_stack(a, nb, tier):
    """Blocked partial-pivot LU of every member of a [batch, n, n] stack.
    Returns ``(lu, perm [batch, n], info [batch])``: ``perm[i]`` member
    i's full row permutation (``a[i][perm[i]] = L·U``), ``info[i]`` its
    zero pivots plus its poisoned panels."""
    a = a.clone()
    batch, n = a.shape[0], a.shape[1]
    dev = a.device
    fd = _factor_dtype(a.dtype)
    info = torch.zeros(batch, dtype=torch.int32, device=dev)
    gperm = torch.arange(n, device=dev).repeat(batch, 1)
    eye = torch.eye(nb, dtype=a.dtype, device=dev)
    for k in range(n // nb):
        r0 = k * nb
        pan = a[:, r0:, r0:r0 + nb].to(fd)
        lu, ipiv, zero = torch.linalg.lu_factor_ex(pan)
        # a member with an exact zero pivot or a non-finite entry takes
        # LAPACK's unblocked loop, which neither swaps nor scales at a
        # zero pivot: cuSOLVER divides there (and treats NaN otherwise),
        # so its factor, and the info counted from it, would differ
        # between the card and the CPU
        redo = (zero > 0) | ~torch.isfinite(pan).flatten(1).all(dim=1)
        # the pivots and the redo flags reach the host in one copy: the
        # panel's only wait for the card
        host = torch.cat([ipiv, redo[:, None].to(ipiv.dtype)], 1).cpu()
        piv = host[:, :-1].numpy()
        for i in np.flatnonzero(host[:, -1].numpy()).tolist():
            lu[i], p0 = _panel_getf2(pan[i].clone())
            piv[i] = (p0 + 1).cpu().numpy()
        perm = _perms_from_ipiv(piv, n - r0, dev)
        # a NaN/Inf panel is zero-filled (its poison reaches no batchmate
        # and no later panel) and counts into info beside the zero pivots
        lu, pbad = finite_guard(lu.to(a.dtype),
                                torch.zeros_like(info), 1)
        a[:, r0:, r0:r0 + nb] = lu
        if r0:
            a[:, r0:, :r0] = _rows(a[:, r0:, :r0], perm)
        gperm[:, r0:] = torch.take_along_dim(gperm[:, r0:], perm, dim=1)
        dg = torch.diagonal(lu[:, :nb, :nb], dim1=-2, dim2=-1)
        info = info + (dg == 0).sum(-1, dtype=torch.int32) + pbad
        if r0 + nb < n:
            right = _rows(a[:, r0:, r0 + nb:], perm)
            unit = lu[:, :nb, :nb].tril(-1) + eye
            with full_f32_matmul():
                urow = torch.linalg.solve_triangular(
                    unit.to(fd), right[:, :nb].to(fd), upper=False,
                    unitriangular=True).to(a.dtype)
            a[:, r0:r0 + nb, r0 + nb:] = urow
            trail = right[:, nb:] - tier_mm(lu[:, nb:, :nb], urow, tier)
            a[:, r0 + nb:, r0 + nb:] = zero_nonfinite(trail)
    return a, gperm.to(torch.int32), info


def _getrs_stack(lu, perm, b):
    fd = _factor_dtype(lu.dtype)
    pb = _rows(b, perm.long()).to(fd)
    with full_f32_matmul():
        y = torch.linalg.solve_triangular(lu.to(fd), pb, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(
            _unit_substituted(lu, False).to(fd), y, upper=True)
    return zero_nonfinite(x.to(b.dtype))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def batched_potrf(a, opts=None, *, nb: int | None = None, device=None):
    """Cholesky-factor a ``[batch, n, n]`` stack (lower). Returns
    ``(l, info)`` with per-member first-block info codes."""
    a = _as_stack(a, device)
    _check_stack(a)
    nb = _resolve_nb(a.shape[1], nb)
    _count("potrf", a)
    return _potrf_stack(a, nb, resolve_tier(opts))


def batched_posv(a, b, opts=None, *, nb: int | None = None, device=None):
    """Solve ``a[i] @ x[i] = b[i]`` for an SPD stack. Returns
    ``(x, l, info)``; a failed member's ``x`` is finite and zero-filled
    where its solve failed, its ``info`` nonzero, its batchmates
    untouched."""
    a = _as_stack(a, device)
    b = _as_stack(b, a.device)
    _check_stack(a, b)
    nb = _resolve_nb(a.shape[1], nb)
    _count("posv", a)
    l, info = _potrf_stack(a, nb, resolve_tier(opts))
    return _potrs_stack(l, b), l, info


def batched_getrf(a, opts=None, *, nb: int | None = None, device=None):
    """Partial-pivot LU of a ``[batch, n, n]`` stack. Returns ``(lu,
    perm, info)``: ``perm[i]`` member i's full row permutation,
    ``info[i]`` its zero-pivot count."""
    a = _as_stack(a, device)
    _check_stack(a)
    nb = _resolve_nb(a.shape[1], nb)
    _count("getrf", a)
    return _getrf_stack(a, nb, resolve_tier(opts))


def batched_gesv(a, b, opts=None, *, nb: int | None = None, device=None):
    """General solve by each member's partial-pivot LU. Returns ``(x, lu,
    perm, info)``."""
    a = _as_stack(a, device)
    b = _as_stack(b, a.device)
    _check_stack(a, b)
    nb = _resolve_nb(a.shape[1], nb)
    _count("gesv", a)
    lu, perm, info = _getrf_stack(a, nb, resolve_tier(opts))
    return _getrs_stack(lu, perm, b), lu, perm, info


def batched_trsm(a, b, *, side: str = "left", lower: bool = True,
                 trans: bool = False, unit: bool = False, device=None):
    """Triangular solve over a leading batch axis: op(a[i])·x[i] = b[i]
    (``side="left"``) or x[i]·op(a[i]) = b[i], op the conjugate
    transpose when ``trans``."""
    a = _as_stack(a, device)
    b = _as_stack(b, a.device)
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    _check_stack(a, b if side == "left" else None)
    _count("trsm", a)
    fd = _factor_dtype(a.dtype)
    t = a.to(fd).mH if trans else a.to(fd)
    with full_f32_matmul():
        x = torch.linalg.solve_triangular(t, b.to(fd), upper=lower == trans,
                                          left=side == "left",
                                          unitriangular=unit)
    return x.to(b.dtype)
