"""Finite guards: the ``info`` side of numerical failure.

A driver reports numerical failure through an ``info`` scalar, the
LAPACK first-failure convention: ``info`` is the 1-based index of the
first failing block column, 0 on success. ``info`` stays a 0-dim int32
tensor on the matrix's device, so a factorization runs to its end
without a host synchronisation per block column.
"""

from __future__ import annotations

import torch


def info_merge(info: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """First-nonzero merge: keep ``info`` if already set, else ``new``
    (the earliest failing block column owns the report, xPOTRF
    semantics)."""
    return torch.where(info != 0, info, new)


def zero_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Replace every non-finite entry of ``x`` with zero, so one bad tile
    cannot turn the whole trailing update into NaN."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def finite_guard(x: torch.Tensor, info: torch.Tensor, code: int, *,
                 diag: bool = False, cplx: bool = False):
    """Guard a factored tile/panel: returns ``(x_clean, info)``.

    If ``x`` holds a non-finite entry (``diag=True`` restricts the check
    to the diagonal, its real part for complex) and no earlier failure
    was recorded, ``info`` becomes ``code``. Non-finite entries are
    zero-filled either way, so the factorization runs to its end with a
    truthful report.
    """
    if diag:
        d = torch.diagonal(x)
        probe = d.real if cplx else d
    else:
        probe = x
    bad = ~torch.isfinite(probe).all()
    new = torch.where(bad, torch.full_like(info, code),
                      torch.zeros_like(info))
    return zero_nonfinite(x), info_merge(info, new)
