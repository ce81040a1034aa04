"""Labeled counters, gauges, histograms and span aggregates (the port's
copy of ``slate_tpu/obs/metrics.py``, host Python only).

The registry is process-global: a metric is a ``(name, sorted label
items)`` key mapping to a float (counter, gauge), a ``[count, sum, min,
max, {bucket: count}]`` summary (histogram) or a ``[count,
total_seconds]`` pair (span aggregate, fed by
:func:`~slate_tpu_torch.obs.span` on exit).

Histograms are the JAX package's ``log`` kind, exact over every
observation within a bucket's geometric width of ~4.9%, which its
serving series ``serve.latency_s`` and ``serve.stage_s`` use; the port
records no other series, so the JAX package's percentile reservoir is
not ported.

While metrics are off every entry point is one boolean test and a
return. A ``threading.Lock`` guards the registry (the JAX package's
``runtime.sync`` lock, which the port does not have yet).
"""

from __future__ import annotations

import math
import threading

_enabled = False
_lock = threading.Lock()

_counters: dict[tuple, float] = {}
_gauges: dict[tuple, float] = {}
_loghists: dict[tuple, list] = {}    # [count, sum, min, max, {idx: n}]
_spans: dict[tuple, list] = {}       # [count, total_seconds]

# exact log-bucket histograms: bucket i covers
# (FLOOR * RATIO**(i-1), FLOOR * RATIO**i], bucket 0 holds v <= FLOOR
LOG_BUCKET_RATIO = 1.1
LOG_BUCKET_FLOOR = 1e-6
_LOG_IDX_CAP = 2048
_LOG_LN_RATIO = math.log(LOG_BUCKET_RATIO)


def _log_index(v: float) -> int:
    if not (v > LOG_BUCKET_FLOOR):      # also catches NaN
        return 0
    if not math.isfinite(v):
        return _LOG_IDX_CAP
    idx = 1 + int(math.floor(math.log(v / LOG_BUCKET_FLOOR) / _LOG_LN_RATIO))
    return min(max(idx, 0), _LOG_IDX_CAP)


def log_bucket_le(idx: int) -> float:
    """Inclusive upper bound of log bucket ``idx``."""
    return LOG_BUCKET_FLOOR * LOG_BUCKET_RATIO ** idx


def _log_rep(le: float) -> float:
    """A bucket's representative value: its geometric midpoint (the
    floor bucket its bound)."""
    if le <= LOG_BUCKET_FLOOR:
        return le
    return le / math.sqrt(LOG_BUCKET_RATIO)


def quantile_from_buckets(buckets: list, q: float) -> float:
    """Quantile from non-cumulative ``[[le, count], ...]`` rows sorted by
    ``le``, exact over all observations within the bucket width."""
    total = sum(c for _, c in buckets)
    if total <= 0:
        return float("nan")
    target = q * total
    cum = 0.0
    for le, c in buckets:
        cum += c
        if cum >= target:
            return _log_rep(le)
    return _log_rep(buckets[-1][0])


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def _coerce(v):
    """Label values must be hashable and JSON-friendly."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted((k, _coerce(v)) for k, v in labels.items())))


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Counter: add ``value`` (default 1)."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def set_gauge(name: str, value: float, **labels) -> None:
    """Gauge: the last value written."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _gauges[k] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Histogram: count, sum, min and max over every observation, and
    its exact log buckets."""
    if not _enabled:
        return
    k = _key(name, labels)
    v = float(value)
    with _lock:
        h = _loghists.setdefault(k, [0, 0.0, v, v, {}])
        h[0] += 1
        h[1] += v
        h[2] = min(h[2], v)
        h[3] = max(h[3], v)
        i = _log_index(v)
        h[4][i] = h[4].get(i, 0) + 1


def record_span_stat(name: str, seconds: float, labels: dict) -> None:
    """Aggregate one finished span."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        s = _spans.setdefault(k, [0, 0.0])
        s[0] += 1
        s[1] += seconds


def counter_value(name: str, **labels) -> float:
    """The value of one exact counter key."""
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def span_seconds_total(name: str) -> float:
    """Seconds of one span name summed over all its label sets."""
    with _lock:
        return sum(s[1] for (n, _), s in _spans.items() if n == name)


def _log_entry(n: str, lk: tuple, h: list) -> dict:
    buckets = [[log_bucket_le(i), h[4][i]] for i in sorted(h[4])]
    return {"name": n, "labels": dict(lk), "count": h[0], "sum": h[1],
            "min": h[2], "max": h[3],
            "p50": quantile_from_buckets(buckets, 0.50),
            "p90": quantile_from_buckets(buckets, 0.90),
            "p99": quantile_from_buckets(buckets, 0.99),
            "kind": "log", "buckets": buckets}


def snapshot() -> dict:
    """The registry's contents, JSON-ready."""
    with _lock:
        hists = [_log_entry(n, lk, h) for (n, lk), h in _loghists.items()]
        hists.sort(key=lambda e: (e["name"],
                                  str(sorted(e["labels"].items()))))
        return {
            "counters": [{"name": n, "labels": dict(lk), "value": v}
                         for (n, lk), v in sorted(_counters.items())],
            "gauges": [{"name": n, "labels": dict(lk), "value": v}
                       for (n, lk), v in sorted(_gauges.items())],
            "histograms": hists,
            "spans": [{"name": n, "labels": dict(lk), "count": s[0],
                       "total_s": s[1]}
                      for (n, lk), s in sorted(_spans.items())],
        }


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _loghists.clear()
        _spans.clear()
