"""Closed-form operation counts of the serving routines (the port's copy
of those rows of ``slate_tpu/obs/flops.py``), the LAPACK Users' Guide /
LAWN 41 conventions: potrf n³/3, getrf mn² − n³/3, and a pair of
triangular solves 2n²·nrhs on top for posv and gesv.

``flop_count`` returns None for an unknown routine or dimensions its
formula does not take; it never raises. The JAX package's table of
peak rates is a TPU's and is not copied.
"""

from __future__ import annotations

import inspect


def _potrf(n):
    return n ** 3 / 3.0


def _getrf(n, m=None):
    m = n if m is None else m
    return m * float(n) ** 2 - n ** 3 / 3.0


def _solve(n, nrhs=1):
    return 2.0 * float(n) ** 2 * nrhs


def _posv(n, nrhs=1):
    return _potrf(n) + _solve(n, nrhs)


def _gesv(n, nrhs=1):
    return _getrf(n) + _solve(n, nrhs)


FLOP_FORMULAS = {"potrf": _potrf, "getrf": _getrf, "posv": _posv,
                 "gesv": _gesv}


def flop_count(routine: str, **dims) -> float | None:
    """The flop count of ``routine`` at ``dims``; dimensions its formula
    does not take are dropped, None when it cannot be computed."""
    fn = FLOP_FORMULAS.get(routine)
    if fn is None:
        return None
    accepted = inspect.signature(fn).parameters
    try:
        return float(fn(**{k: v for k, v in dims.items()
                           if v is not None and k in accepted}))
    except (TypeError, ValueError):
        return None
