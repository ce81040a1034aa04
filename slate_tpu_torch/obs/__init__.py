"""The parts of the JAX package's ``obs`` layer that serving reads:
labeled counters, gauges and histograms (:mod:`.metrics`), request
correlation IDs (:mod:`.correlation`), flop counts (:mod:`.flops`) and
host spans, behind the façade of ``slate_tpu/obs/__init__.py``
(``count``, ``gauge``, ``observe``, ``span``).

Metrics are off until :func:`metrics_on`; then every span's host seconds
land in its aggregate. A span is timed on the host clock: what it
encloses must end on the host, so a span around card work encloses the
copy of its result to the host (the JAX package blocks on its result
there too). Device tracing, the exporters, the flight recorder, the
roofline and the rest of the JAX ``obs`` layer are not ported yet.
"""

from __future__ import annotations

import time

from . import correlation, flops, metrics
from .flops import flop_count
from .metrics import counter_value

count = metrics.inc
gauge = metrics.set_gauge
observe = metrics.observe


def metrics_on() -> None:
    metrics.enable()


def metrics_off() -> None:
    metrics.disable()


class _Span:
    """A region timed on the host clock; its seconds go to the span
    aggregate under (name, labels)."""

    __slots__ = ("name", "labels", "_start")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        metrics.record_span_stat(self.name,
                                 time.perf_counter() - self._start,
                                 self.labels)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, **labels):
    """A host-clock span; a no-op while metrics are off."""
    if not metrics.enabled():
        return _NOOP
    return _Span(name, labels)


def dump() -> dict:
    """The metrics snapshot (counters, gauges, histograms, spans)."""
    snap = metrics.snapshot()
    snap["metrics_enabled"] = metrics.enabled()
    return snap


def reset() -> None:
    """Clear every aggregate."""
    metrics.reset()


__all__ = ["correlation", "flops", "metrics", "count", "gauge", "observe",
           "span", "counter_value", "flop_count", "metrics_on",
           "metrics_off", "dump", "reset"]
