"""The serving layer's per-request check of a solution (the port's copy
of ``tolerance``, ``detect`` and ``verify_solve`` of
``slate_tpu/robust/abft.py``): a residual computed on the host.

The tolerance is the JAX package's τ(tier, n) = 64·√n·tier_eps(tier) on
the relative backward residual ‖a·x − b‖∞ / (‖a‖∞·‖x‖∞·n + ‖b‖∞). The
checksum verification of the factorizations' step loops and its
recovery ladder are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import obs
from ..internal.precision import tier_eps

THRESHOLD_C = 64.0


def tolerance(tier: str, n: int) -> float:
    """τ(tier, n) on the relative residual."""
    return THRESHOLD_C * math.sqrt(max(int(n), 1)) * tier_eps(tier)


@dataclasses.dataclass(frozen=True)
class Detection:
    """One violated check."""

    routine: str
    phase: str
    tile_col: int
    resid: float


_detections: list[Detection] = []


def detection_log() -> tuple[Detection, ...]:
    return tuple(_detections)


def clear_detections() -> None:
    _detections.clear()


def detect(routine: str, phase: str, tile_col: int, resid: float) -> None:
    """Record one violation in the log and count it as ``abft.detect``."""
    _detections.append(Detection(routine=routine, phase=phase,
                                 tile_col=int(tile_col), resid=float(resid)))
    obs.count("abft.detect", routine=routine, phase=phase)


def verify_solve(routine: str, a, b, x, tier: str):
    """The residual check of one served solve: ``(verified, resid)``,
    with a detection recorded when the residual exceeds τ(tier, n)."""
    a = np.asarray(a)
    n = a.shape[0]
    b2 = np.asarray(b).reshape(n, -1)
    x2 = np.asarray(x).reshape(n, -1)
    tiny = np.finfo(np.float64).tiny
    num = float(np.abs(a @ x2 - b2).max()) if n else 0.0
    den = (float(np.abs(a).max(initial=0.0))
           * float(np.abs(x2).max(initial=0.0)) * n
           + float(np.abs(b2).max(initial=0.0)) + tiny)
    resid = num / den
    ok = resid <= tolerance(tier, n)
    if not ok:
        detect(routine, "serve", -1, resid)
    return bool(ok), resid
