"""Precision tiers for the O(n³) trailing updates.

The JAX package names three tiers after its TPU matmul lowerings
(``mxu_bf16``, ``bf16_3x``, ``bf16_6x``) and states the contract of each
as a per-dot unit roundoff, ``TIER_EPS``. The port keeps the contract,
not the lowerings:

* ``bf16_6x`` — true FP32, the default. On the card a float32 matmul may
  run in TF32 when the caller has turned that on process-wide
  (``torch.backends.cuda.matmul.allow_tf32``); TF32 keeps 10 mantissa
  bits, far from 2⁻²⁴. So every trailing update at this tier runs under
  :func:`full_f32_matmul`, which pins float32 matmuls to full precision
  for the duration of the call and restores the caller's setting after.
  This is the counterpart of the JAX package's per-call ``precision=``
  argument; nothing is changed process-wide at import.
* ``bf16_3x`` and ``mxu_bf16`` raise :class:`SlateError`: TF32 does not
  meet ``TIER_EPS["bf16_3x"] = 2⁻¹⁸``, so the choice between a
  split-operand scheme and a redefinition of the tier is still open.

Panels and triangular solves always run at full FP32 whatever the tier.
"""

from __future__ import annotations

import contextlib

import torch

from ..errors import SlateError, slate_error_if

# Canonical tier names, slowest/most-accurate last.
TIERS = ("mxu_bf16", "bf16_3x", "bf16_6x")

DEFAULT_TIER = "bf16_6x"

# Per-dot unit roundoff per tier (the accuracy contract).
TIER_EPS = {
    "mxu_bf16": 2.0 ** -8,
    "bf16_3x": 2.0 ** -18,
    "bf16_6x": 2.0 ** -24,
}

PORTED_TIERS = ("bf16_6x",)


def resolve_tier(opts=None) -> str:
    """Read ``Option.TrailingPrecision`` from an opts mapping; returns a
    validated tier name (default :data:`DEFAULT_TIER`)."""
    from ..types import Option, get_option
    tier = get_option(opts, Option.TrailingPrecision, DEFAULT_TIER)
    slate_error_if(tier not in TIERS,
                   f"unknown precision tier {tier!r}; expected one of "
                   f"{TIERS}")
    if tier not in PORTED_TIERS:
        raise SlateError(
            f"precision tier {tier!r} is not ported yet: TF32 keeps 10 "
            f"mantissa bits and does not meet its per-dot bound "
            f"{TIER_EPS[tier]:.3g}; only 'bf16_6x' (full FP32) runs")
    return tier


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls inside the block run in full FP32 (TF32 off); the
    caller's setting is restored on exit.

    PyTorch has two APIs for this flag and raises once a process has
    used both, so the block uses the one the caller used: the legacy
    ``allow_tf32`` unless reading it raises because the caller set the
    newer ``fp32_precision``."""
    mm = torch.backends.cuda.matmul
    try:
        prev = mm.allow_tf32
    except RuntimeError:
        prev = None
    if prev is None:
        prev_precision = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev_precision
        return
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = prev


def trailing_matmul(tier: str):
    """Context for a trailing-update matmul at ``tier`` (only bf16_6x
    is ported, see the module note)."""
    slate_error_if(tier not in PORTED_TIERS,
                   f"precision tier {tier!r} is not ported yet")
    return full_f32_matmul()
