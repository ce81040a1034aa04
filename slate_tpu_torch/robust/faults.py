"""Deterministic, seedable fault injection (the port's copy of the parts
of ``slate_tpu/robust/faults.py`` that serving reads).

A fault is armed by the ``SLATE_TPU_FAULTS`` environment variable, a
comma-separated list of ``kind[:seed=N][:target=name]``, the JAX
package's syntax, or by the :func:`inject` context manager, which
replaces the env-derived set for its extent (``with faults.inject():``
arms nothing). Every fired injection is appended to
:func:`injection_log` and counted as ``faults.injected``.

The port arms the two kinds that serving reads, ``nan_tile`` and
``singular_pivot`` (``serve/ragged.py`` corrupts one member of a group
with each). The JAX package's other kinds, and its ``fires=N`` (how
often a per-step fault lands), have no hook here yet: a spec naming
one raises rather than arming nothing. A kind neither package knows is
ignored, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

from ..errors import SlateError

ENV = "SLATE_TPU_FAULTS"

KINDS = ("nan_tile", "singular_pivot")

# the JAX package's kinds whose hooks (the routines' operands, the native
# toolchain, preemption, checkpoints, bit flips) are not ported
NOT_PORTED = ("inf_tile", "native_missing", "compile_timeout", "preempt",
              "ckpt_corrupt", "bit_flip_tile")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: ``kind`` with a ``seed`` and an optional
    ``target`` (a routine name; empty matches every target)."""

    kind: str
    seed: int = 0
    target: str = ""


@dataclasses.dataclass(frozen=True)
class InjectionRecord:
    """One fired injection: what was corrupted, where."""

    kind: str
    where: str
    detail: str = ""


_parse_cache: tuple[str, tuple[FaultSpec, ...]] | None = None
_override: tuple[FaultSpec, ...] | None = None
_log: list[InjectionRecord] = []


def _parse(spec: str) -> tuple[FaultSpec, ...]:
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        kind, seed, target = parts[0], 0, ""
        if kind in NOT_PORTED:
            raise SlateError(f"fault kind {kind!r} is not ported: the port "
                             f"arms {', '.join(KINDS)}")
        if kind not in KINDS:
            continue                      # unknown kinds are ignored
        for p in parts[1:]:
            if p.startswith("seed="):
                seed = int(p[5:])
            elif p.startswith("target="):
                target = p[7:]
            elif p.startswith("fires="):
                raise SlateError(f"{item!r}: fires= is not ported (no "
                                 f"armed kind lands per step)")
        out.append(FaultSpec(kind=kind, seed=seed, target=target))
    return tuple(out)


def active() -> tuple[FaultSpec, ...]:
    """The armed set: the :func:`inject` override when one is installed,
    else the parsed ``SLATE_TPU_FAULTS``."""
    global _parse_cache
    if _override is not None:
        return _override
    raw = os.environ.get(ENV, "")
    if not raw:
        return ()
    if _parse_cache is None or _parse_cache[0] != raw:
        _parse_cache = (raw, _parse(raw))
    return _parse_cache[1]


def enabled(kind: str, target: str = "") -> FaultSpec | None:
    """The first armed spec of ``kind`` matching ``target``, or None."""
    for spec in active():
        if spec.kind == kind and (not spec.target or spec.target == target):
            return spec
    return None


class inject:
    """Install a fault set that replaces the env-derived one for the
    ``with`` extent::

        with faults.inject("nan_tile:seed=3:target=posv"):
            ...
    """

    def __init__(self, *specs: str | FaultSpec):
        parsed: list[FaultSpec] = []
        for s in specs:
            if isinstance(s, FaultSpec):
                parsed.append(s)
            else:
                parsed.extend(_parse(s))
        self._specs = tuple(parsed)
        self._prev: tuple[FaultSpec, ...] | None = None

    def __enter__(self):
        global _override
        self._prev = _override
        _override = self._specs
        return self

    def __exit__(self, *exc):
        global _override
        _override = self._prev
        return False


def record(kind: str, where: str, detail: str = "") -> None:
    """Log one fired injection and count it as ``faults.injected``."""
    _log.append(InjectionRecord(kind=kind, where=where, detail=detail))
    from .. import obs
    obs.count("faults.injected", kind=kind, where=where)


def injection_log() -> tuple[InjectionRecord, ...]:
    return tuple(_log)


def clear_log() -> None:
    _log.clear()
