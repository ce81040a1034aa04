"""Precision tiers for the O(n³) trailing updates.

The JAX package names three tiers after its TPU matmul lowerings
(``mxu_bf16``, ``bf16_3x``, ``bf16_6x``) and states the contract of each
as a per-dot unit roundoff, ``TIER_EPS``. The port keeps the contract
and lowers each tier onto the H100's tensor cores:

* ``bf16_6x`` — true FP32, the default: one FP32 matmul with TF32 off
  (:func:`full_f32_matmul`). On the card a float32 matmul may run in
  TF32 when the caller has turned that on process-wide, and TF32 keeps
  10 mantissa bits, far from 2⁻²⁴; the pin restores the caller's
  setting after the call.
* ``bf16_3x`` — a 3×TF32 split. Each operand splits into
  hi = round_tf32(x) and lo = round_tf32(x − hi); the product is
  hi·hi′ + hi·lo′ + lo·hi′, three TF32 tensor-core products with FP32
  accumulation, issued as one matmul over the operands laid side by
  side along the contraction ([hi, hi, lo] · [hi′; lo′; hi′]). hi and lo
  keep 11 significant bits each, so x − hi − lo is within 2⁻²² of x and
  the dropped lo·lo′ term is within 2⁻²² of |x·x′|: a product carries
  about 3·2⁻²² + 2⁻²³ < 2⁻²⁰ at k = 1, inside 2⁻¹⁸. A bf16×3 split keeps
  only 16 bits and would not meet 2⁻¹⁸.
* ``mxu_bf16`` — one bf16 pass: both operands are rounded to bf16 and
  kept in f32 storage, then multiplied by one TF32 matmul. bf16 values
  are exact in TF32, so this is a bf16 tensor-core product with FP32
  accumulation and output, what the JAX tier computes on the MXU.
  ``TIER_EPS["mxu_bf16"]`` = 2⁻⁸ is bf16's unit roundoff; each of the two
  rounded operands carries up to 2⁻⁸, so a product carries up to
  2·2⁻⁸ + 2⁻¹⁶ (:func:`product_bound`).

The rounding to TF32 and to bf16 is explicit (round to nearest even on
the bits, :func:`round_tf32`, :func:`round_bf16`) rather than left to
cuBLAS's input conversion, so the CPU computes what the card computes,
up to the order of summation, and the CPU tests exercise the split.

Only f32 products take a tier (the JAX package's ``_tierable``); f64 and
every other dtype keep one plain product. Panels and triangular solves
always run at full FP32 whatever the tier.
"""

from __future__ import annotations

import contextlib

import torch

from ..errors import slate_error_if

# Canonical tier names, slowest/most-accurate last.
TIERS = ("mxu_bf16", "bf16_3x", "bf16_6x")

DEFAULT_TIER = "bf16_6x"

# Per-dot unit roundoff per tier (the accuracy contract).
TIER_EPS = {
    "mxu_bf16": 2.0 ** -8,
    "bf16_3x": 2.0 ** -18,
    "bf16_6x": 2.0 ** -24,
}

F32_EPS = 2.0 ** -24


def tier_eps(tier: str) -> float:
    """The documented unit roundoff a product carries at ``tier``."""
    return TIER_EPS[tier]


def resolve_tier(opts=None) -> str:
    """Read ``Option.TrailingPrecision`` from an opts mapping; returns a
    validated tier name (default :data:`DEFAULT_TIER`)."""
    from ..types import Option, get_option
    tier = get_option(opts, Option.TrailingPrecision, DEFAULT_TIER)
    slate_error_if(tier not in TIERS,
                   f"unknown precision tier {tier!r}; expected one of "
                   f"{TIERS}")
    return tier


def product_bound(tier: str, k: int) -> float:
    """Elementwise bound of a tier product of contraction k against the
    exact one, relative to |A|·|B|: the tier's per-product error (k = 0:
    TIER_EPS, and for mxu_bf16 2·TIER_EPS + TIER_EPS² for its two
    operands rounded to bf16) plus k FP32 accumulations."""
    u = TIER_EPS[tier]
    per = 2 * u + u * u if tier == "mxu_bf16" else u
    return per + k * F32_EPS


@contextlib.contextmanager
def _tf32_flag(on: bool):
    """Float32 matmuls inside the block run in TF32 (``on``) or in full
    FP32; the caller's setting is restored on exit, also when the body
    raises.

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
        mm.fp32_precision = "tf32" if on else "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev_precision
        return
    mm.allow_tf32 = on
    try:
        yield
    finally:
        mm.allow_tf32 = prev


def full_f32_matmul():
    """Float32 matmuls inside the block run in full FP32 (TF32 off); the
    caller's setting is restored on exit."""
    return _tf32_flag(False)


def tf32_matmul():
    """Float32 matmuls inside the block run on the TF32 tensor cores;
    the caller's setting is restored on exit. Only operands already
    rounded to TF32 (or bf16) go through it, so the tensor cores' input
    conversion drops no bit."""
    return _tf32_flag(True)


# ---------------------------------------------------------------------------
# rounding on the bits (round to nearest, ties to even)
# ---------------------------------------------------------------------------

def _round_bits(x: torch.Tensor, drop: int) -> torch.Tensor:
    """``x`` (f32) rounded to nearest even with its ``drop`` low
    mantissa bits cleared; Inf and NaN pass unchanged, a value rounded
    past the largest finite one becomes Inf."""
    bits = x.view(torch.int32)
    half = (1 << (drop - 1)) - 1
    up = bits + (half + ((bits >> drop) & 1))
    out = (up & -(1 << drop)).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (11 significant bits), in f32 storage."""
    return _round_bits(x.contiguous(), 13)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (8 significant bits), in f32 storage."""
    return _round_bits(x.contiguous(), 16)


# ---------------------------------------------------------------------------
# products at a tier
# ---------------------------------------------------------------------------

def _tierable(dtype: torch.dtype) -> bool:
    return dtype == torch.float32


def tier_context(tier: str, dtype: torch.dtype = torch.float32):
    """The matmul setting under which :func:`tier_lhs` · :func:`tier_rhs`
    computes the product at ``tier``: TF32 on for the split and rounded
    tiers, full FP32 otherwise."""
    if _tierable(dtype) and tier != "bf16_6x":
        return tf32_matmul()
    return full_f32_matmul()


def tier_lhs(a: torch.Tensor, tier: str) -> torch.Tensor:
    """The left operand ``a`` [.., m, k] as the tier multiplies it:
    bf16_3x [hi, hi, lo] along k ([.., m, 3k]); mxu_bf16 rounded to
    bf16; otherwise ``a`` itself."""
    if not _tierable(a.dtype) or tier == "bf16_6x":
        return a
    if tier == "mxu_bf16":
        return round_bf16(a)
    hi = round_tf32(a)
    lo = round_tf32(a - hi)
    return torch.cat([hi, hi, lo], dim=-1)


def tier_rhs(b: torch.Tensor, tier: str) -> torch.Tensor:
    """The right operand ``b`` [.., k, n] as the tier multiplies it:
    bf16_3x [hi; lo; hi] along k ([.., 3k, n]); mxu_bf16 rounded to
    bf16; otherwise ``b`` itself."""
    if not _tierable(b.dtype) or tier == "bf16_6x":
        return b
    if tier == "mxu_bf16":
        return round_bf16(b)
    hi = round_tf32(b)
    lo = round_tf32(b - hi)
    return torch.cat([hi, lo, hi], dim=-2)


def tier_mm(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """a·b at ``tier``; a new tensor."""
    with tier_context(tier, a.dtype):
        return tier_lhs(a, tier) @ tier_rhs(b, tier)


def tier_addmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
               beta=1.0, alpha=1.0, tier: str) -> torch.Tensor:
    """beta·c + alpha·a·b with the product at ``tier``; a new tensor."""
    with tier_context(tier, a.dtype):
        return torch.addmm(c, tier_lhs(a, tier), tier_rhs(b, tier),
                           beta=beta, alpha=alpha)


def tier_addmm_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                beta=1.0, alpha=1.0, tier: str) -> torch.Tensor:
    """out ← beta·out + alpha·a·b in place, ``out`` a tensor or a view
    of one, with the product at ``tier``; returns ``out``."""
    with tier_context(tier, a.dtype):
        return out.addmm_(tier_lhs(a, tier), tier_rhs(b, tier),
                          beta=beta, alpha=alpha)
