"""Exceptions (reference include/slate/Exception.hh:53-176).

SLATE raises ``slate::Exception`` via ``slate_error`` / ``slate_error_if``;
the port exposes the same contract as a Python exception plus a guard
helper. Numerical failure is reported through ``info`` values (the
LAPACK positive-info convention), so a factorization never has to stop
the device stream to raise.
"""


class SlateError(RuntimeError):
    """Framework error (reference slate::Exception, Exception.hh:53)."""


class InfoError(SlateError):
    """A driver reported numerical failure through its ``info`` code.
    Carries ``routine`` and the integer ``info`` so callers can branch on
    the failure programmatically."""

    def __init__(self, routine: str, info: int, message: str):
        self.routine = routine
        self.info = int(info)
        super().__init__(f"{routine}: {message} (info={self.info})")


# how each routine family encodes positive info; {info} is interpolated
_INFO_MESSAGES = {
    "potrf": "the leading minor ending at block column {info} is not "
             "positive definite; the factorization could not be "
             "completed",
    "getrf": "U is exactly singular ({info} zero pivot(s)); a solve "
             "would divide by zero",
    "gbtrf": "U is exactly singular ({info} zero pivot(s)); a solve "
             "would divide by zero",
    "hetrf": "the LTL^H factorization hit {info} zero pivot(s); the "
             "factor is singular",
}


def raise_if_info(info, routine: str) -> None:
    """Raise :class:`InfoError` when a driver's ``info`` is nonzero.

    Reads ``info`` on the host (a device scalar is synchronised).
    Negative info follows the LAPACK argument-error convention; positive
    info maps to the routine family's message above.
    """
    i = int(info)
    if i == 0:
        return
    if i < 0:
        msg = f"argument {-i} had an illegal value"
    else:
        tmpl = _INFO_MESSAGES.get(
            routine, "numerical failure at/with code {info}")
        msg = tmpl.format(info=i)
    raise InfoError(routine, i, msg)


def slate_error_if(cond: bool, msg: str) -> None:
    """Raise :class:`SlateError` when ``cond`` holds (reference
    Exception.hh:91-113). Host-side conditions only."""
    if cond:
        raise SlateError(msg)
