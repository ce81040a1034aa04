"""Finite guards and health reports: the ``info`` side of numerical
failure (counterpart of ``slate_tpu/robust/guards.py``).

A driver reports numerical failure through an ``info`` scalar, the
LAPACK first-failure convention: ``info`` is the 1-based index of the
first failing block column, 0 on success. ``info`` stays a 0-dim int32
tensor on the matrix's device, so a factorization runs to its end
without a host synchronisation per block column. On request
(``health=True``) a driver returns a :class:`HealthReport` in its place,
and the last reports are kept in a bounded log.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
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
    truthful report. A stack ``x [batch, …]`` with ``info [batch]`` is
    guarded member by member (the JAX package's guard under ``vmap``):
    each member's report comes from its own entries.
    """
    if diag:
        d = torch.diagonal(x, dim1=-2, dim2=-1)
        probe = d.real if cplx else d
    else:
        probe = x
    fin = torch.isfinite(probe)
    bad = ~(fin.flatten(1).all(dim=1) if info.dim() else fin.all())
    new = torch.where(bad, torch.full_like(info, code),
                      torch.zeros_like(info))
    return zero_nonfinite(x), info_merge(info, new)


# ---------------------------------------------------------------------------
# host-side twin
# ---------------------------------------------------------------------------

def host_info_from_diag(diag, nb: int) -> int:
    """LAPACK first-failure info from a host-side factor diagonal: the
    1-based block column of the first non-finite entry, 0 when the whole
    diagonal is finite (the numpy twin of ``finite_guard(diag=True)``)."""
    diag = np.asarray(diag)
    bad = ~np.isfinite(diag.real if np.iscomplexobj(diag) else diag)
    if not bad.any():
        return 0
    return int(np.argmax(bad)) // nb + 1


# ---------------------------------------------------------------------------
# HealthReport, the driver-level report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Numerical-health record a factorization returns on request.

    ``info`` follows the routine's LAPACK convention; ``first_bad_tile``
    locates the failure in block coordinates when the convention names
    one; ``growth`` is the reciprocal-condition estimate from
    ``condest`` (None when the factorization failed); ``demotions`` and
    ``notes`` carry backend demotions and free text. ``request_id`` is
    the serving layer's correlation stamp; ``verified`` and
    ``checksum_resid`` carry a served request's residual check
    (``robust/abft.verify_solve``) and stay None elsewhere.
    """

    routine: str
    info: int
    first_bad_tile: tuple[int, int] | None = None
    growth: float | None = None
    demotions: tuple = ()
    notes: str = ""
    request_id: str = ""
    verified: bool | None = None
    checksum_resid: float | None = None

    @property
    def ok(self) -> bool:
        return self.info == 0

    def __int__(self) -> int:
        return self.info

    def as_dict(self) -> dict:
        return {
            "routine": self.routine,
            "info": self.info,
            "first_bad_tile": self.first_bad_tile,
            "growth": self.growth,
            "demotions": tuple(str(d) for d in self.demotions),
            "notes": self.notes,
            "request_id": self.request_id,
            "verified": self.verified,
            "checksum_resid": self.checksum_resid,
        }


def health_report(routine: str, info, *, convention: str = "first_block",
                  growth: float | None = None, demotions=(),
                  notes: str = "", request_id: str = "",
                  verified: bool | None = None,
                  checksum_resid: float | None = None) -> HealthReport:
    """Build a :class:`HealthReport` from a driver's ``info`` and record
    it in the report log. ``convention`` decodes ``info``:

    * ``"first_block"`` (potrf): positive info is the 1-based index of
      the first failing block column, so the bad tile is the diagonal
      block ``(info-1, info-1)``;
    * ``"count"`` (getrf, hetrf): info counts zero pivots, and no single
      coordinate exists.

    ``request_id`` defaults to the correlation IDs bound where the report
    is built (:mod:`..obs.correlation`), so a report made inside a
    serving dispatch names its request.
    """
    from ..obs import correlation
    i = int(info)
    first_bad = (i - 1, i - 1) if i > 0 and convention == "first_block" \
        else None
    r = HealthReport(routine=routine, info=i, first_bad_tile=first_bad,
                     growth=growth, demotions=tuple(demotions), notes=notes,
                     request_id=request_id or correlation.current(),
                     verified=None if verified is None else bool(verified),
                     checksum_resid=(None if checksum_resid is None
                                     else float(checksum_resid)))
    _record_report(r)
    return r


# ---------------------------------------------------------------------------
# the report log
# ---------------------------------------------------------------------------

_REPORT_LOG_CAP = 64
_reports: collections.deque = collections.deque(maxlen=_REPORT_LOG_CAP)
_bad_total = 0
_report_lock = threading.Lock()


def _record_report(r: HealthReport) -> None:
    global _bad_total
    with _report_lock:
        _reports.append(r)
        if not r.ok:
            _bad_total += 1


def recent_reports() -> tuple[HealthReport, ...]:
    """The last ``_REPORT_LOG_CAP`` reports built, oldest first."""
    with _report_lock:
        return tuple(_reports)


def bad_report_total() -> int:
    """Count of nonzero-``info`` reports over the process lifetime."""
    with _report_lock:
        return _bad_total


def reset_report_log() -> None:
    global _bad_total
    with _report_lock:
        _reports.clear()
        _bad_total = 0
