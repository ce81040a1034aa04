"""Request-scoped correlation IDs (the port's copy of
``slate_tpu/obs/correlation.py``).

A context variable carries the IDs of the requests in flight for the
extent of a dispatch (comma-joined: a batched dispatch serves many
requests at once). An ID never becomes a metrics label: the serving
series label on the low-cardinality ``tenant`` and ``slo_class``. The
JAX package's set of admitted, unresolved requests waits for the
scheduler that reads it.
"""

from __future__ import annotations

import contextvars
import os
import threading

_RIDS: contextvars.ContextVar[str] = contextvars.ContextVar(
    "slate_tpu_torch_rids", default="")

_lock = threading.Lock()
_counter = 0


def new_id(prefix: str = "r") -> str:
    """A process-unique ID ``r-<pid>-<seq>-<rand>``: sortable within a
    process, the random suffix keeps processes apart."""
    global _counter
    with _lock:
        _counter += 1
        seq = _counter
    return f"{prefix}-{os.getpid()}-{seq}-{os.urandom(3).hex()}"


def current() -> str:
    """The IDs bound to this context, comma-joined ("" outside any)."""
    return _RIDS.get()


class bind:
    """Bind request IDs to the current context for a ``with`` extent;
    nested binds replace the stamp and restore the outer one on exit."""

    __slots__ = ("_rids", "_token")

    def __init__(self, *rids: str):
        self._rids = ",".join(r for r in rids if r)
        self._token = None

    def __enter__(self):
        self._token = _RIDS.set(self._rids)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _RIDS.reset(self._token)
            self._token = None
        return False
