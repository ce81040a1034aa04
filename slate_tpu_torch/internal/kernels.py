"""Hand-written CUDA kernels of the tile layer, their plain versions and
their capability table — the counterpart of
``slate_tpu/internal/pallas_kernels.py``.

Each kernel has three parts here:

* a wrapper (``potrf_tile``, ``trsm_right_lower_t``, ``trsm_left_lower``)
  that launches the kernel of ``csrc/`` for a CUDA tensor and counts the
  launch in :data:`LAUNCHES`, runs the plain version for a CPU tensor,
  and raises for anything else. There is no fallback from a failed build
  or launch;
* a plain PyTorch version (``*_plain``) that repeats the kernel's blocked
  algorithm with torch ops. The CPU runs it, and on the card it is what
  the kernel is checked against;
* a source note on the wrapper: the Pallas function it replaces, what
  bounds it on an H100 and what its design does about that.

The dispatch sites in :mod:`.tile_kernels` consult :data:`CAPABILITY`
(platform → kernel → dtype → (nb_min, nb_max, nb_multiple), modelled on
``pallas_kernels.py:75-114``); what it does not admit goes to the
``torch.linalg`` op, as the JAX package sends it to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import SlateError, slate_error_if
from .precision import full_f32_matmul

# Column-block width of the kernels (TS in csrc/common.cuh); the plain
# versions block the same way.
BS = 64

_SPAN = (1, 1024, 1)
_CAPS_CUDA = {
    "potrf_tile": {"float32": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN},
    "trsm_left_lower": {"float32": _SPAN},
}
_CAPS_CPU = {
    "potrf_tile": {"float32": _SPAN, "float64": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN, "float64": _SPAN},
    "trsm_left_lower": {"float32": _SPAN, "float64": _SPAN},
}
CAPABILITY = {"cuda": _CAPS_CUDA, "cpu": _CAPS_CPU}

# Launches of each kernel on the card since the last reset. A wrapper
# adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"potrf_tile": 0, "trsm_right_lower_t": 0, "trsm_left_lower": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(kernel: str, dtype: torch.dtype, nb: int,
              device: torch.device | str) -> bool:
    """Whether ``kernel`` (or, on the CPU, its plain version) takes a
    factor of width ``nb`` and type ``dtype`` on ``device``."""
    platform = torch.device(device).type
    spec = CAPABILITY.get(platform, {}).get(kernel, {}).get(
        str(dtype).removeprefix("torch."))
    if spec is None:
        return False
    lo, hi, mult = spec
    return lo <= nb <= hi and nb % mult == 0


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "slate_potrf_tile_f32": ("potrf_tile", (_P, _I, _P, _P)),
    "slate_trsm_right_lower_t_f32": ("trsm_lower", (_P, _P, _I, _I, _I, _P)),
    "slate_trsm_left_lower_f32": ("trsm_lower", (_P, _P, _I, _I, _I, _P)),
}
_FNS: dict = {}


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise if
    it reports a CUDA error."""
    fn = _FNS.get(symbol)
    if fn is None:
        from ._build import library
        source, argtypes = _SIGNATURES[symbol]
        fn = getattr(library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, _P(stream))
    if rc != 0:
        raise SlateError(f"{symbol}: CUDA error {rc} at launch")


def _check(kernel: str, nb: int, *ts: torch.Tensor) -> None:
    for t in ts:
        slate_error_if(t.device.type != "cuda" or t.dtype != torch.float32
                       or t.dim() != 2,
                       f"{kernel}: the kernel takes 2-D float32 CUDA "
                       f"tensors, got {t.dtype} {tuple(t.shape)} on "
                       f"{t.device}")
    slate_error_if(not supported(kernel, ts[0].dtype, nb, ts[0].device),
                   f"{kernel}: width {nb} is outside the capability table")


def _route(kernel: str, t: torch.Tensor) -> bool:
    """True for the card, False for the CPU's plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise SlateError(f"{kernel}: no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# K1: tile Cholesky
# ---------------------------------------------------------------------------

def potrf_tile(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one [nb, nb] tile; the upper triangle
    comes out zeroed. The lower triangle of ``a`` is read.

    Replaces ``potrf_tile_pallas`` (pallas_kernels.py:428), which keeps
    the tile in VMEM. Bound on an H100: FP32 operations (nb³/3 FMAs on
    the CUDA cores) at large nb, but the column-by-column diagonal blocks
    are latency-bound, one CTA each. Design (csrc/potrf_tile.cu): the
    tile stays in global memory (4 MB at nb = 1024, resident in L2) and
    is walked in 64-column blocks, three launches per block from a host
    loop: the diagonal block factored and inverted by one CTA in shared
    memory, the panel T·L⁻ᵀ over a grid of CTAs, the lower trailing
    tiles −P·Pᵀ over a grid of CTAs. Any nb from 1 to 1024; the ragged
    last block is masked. A non-positive pivot comes out as NaN on the
    diagonal (``sqrtf`` of a negative), for the caller's finite guard.
    """
    if not _route("potrf_tile", a):
        return potrf_tile_plain(a)
    nb = a.shape[-1]
    _check("potrf_tile", nb, a)
    slate_error_if(a.shape[0] != nb, "potrf_tile: square tile expected")
    out = a.clone(memory_format=torch.contiguous_format)
    inv = torch.empty(BS * BS, dtype=torch.float32, device=a.device)
    _launch("slate_potrf_tile_f32", a.device, _P(out.data_ptr()), nb,
            _P(inv.data_ptr()))
    LAUNCHES["potrf_tile"] += 1
    return out


def _chol_unblocked(d: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of a small block, in place, column by
    column (the kernel's ``chol_diag`` loop)."""
    w = d.shape[0]
    for j in range(w):
        piv = torch.sqrt(d[j, j])
        d[j, j] = piv
        d[j + 1:, j] /= piv
        d[j + 1:, j + 1:] -= torch.outer(d[j + 1:, j], d[j + 1:, j])
    return d.tril_()


def _inv_lower(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a small lower-triangular block by forward
    substitution."""
    w = l.shape[0]
    eye = torch.eye(w, dtype=l.dtype, device=l.device)
    x = torch.zeros_like(l)
    for i in range(w):
        x[i] = (eye[i] - l[i, :i] @ x[:i]) / l[i, i]
    return x


def potrf_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`potrf_tile`: the same 64-column
    blocked algorithm."""
    a = a.clone()
    nb = a.shape[0]
    with full_f32_matmul():
        for j0 in range(0, nb, BS):
            e = min(nb, j0 + BS)
            d = _chol_unblocked(a[j0:e, j0:e].clone())
            a[j0:e, j0:e] = d
            if e < nb:
                p = a[e:, j0:e] @ _inv_lower(d).mT
                a[e:, j0:e] = p
                a[e:, e:] -= p @ p.mT
    return a.tril()


# ---------------------------------------------------------------------------
# K2 / K3: triangular solves against a lower factor
# ---------------------------------------------------------------------------

def trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor,
                       unit: bool = False) -> torch.Tensor:
    """X = B·L⁻ᵀ for lower L [n, n] and B [m, n]; a new tensor.

    Replaces ``trsm_right_lower_t_pallas`` (pallas_kernels.py:613), the
    potrf panel solve. Bound on an H100: FP32 operations (m·n² flops on
    the CUDA cores; at the panel [15360, 1024] the bytes are a tenth of
    that in time). Design (csrc/trsm_lower.cu): a row of X depends only
    on the same row of B, so a grid of CTAs takes 64 rows each and runs
    blocked column substitution against L with no dependence across CTAs
    — no diagonal-block inverses as in the VMEM-resident Pallas kernel.
    Per 64-column block, the solved blocks are subtracted as 64×64×64
    products from shared-memory tiles, then the block is substituted
    column by column, four lanes per row.
    """
    if not _route("trsm_right_lower_t", b):
        return trsm_right_lower_t_plain(l, b, unit)
    m, n = b.shape
    _check("trsm_right_lower_t", n, l, b)
    slate_error_if(tuple(l.shape) != (n, n), "trsm_right_lower_t dims")
    lc = l.contiguous()
    x = b.clone(memory_format=torch.contiguous_format)
    _launch("slate_trsm_right_lower_t_f32", b.device, _P(lc.data_ptr()),
            _P(x.data_ptr()), m, n, int(unit))
    LAUNCHES["trsm_right_lower_t"] += 1
    return x


def trsm_left_lower(l: torch.Tensor, b: torch.Tensor,
                    unit: bool = False) -> torch.Tensor:
    """X = L⁻¹·B for lower L [n, n] and B [n, m]; a new tensor.

    Replaces ``trsm_left_lower_pallas`` (pallas_kernels.py:594), here the
    potrs forward solve of one diagonal tile against a block row. Bound on
    an H100: FP32 operations (n²·m flops). Design: the kernel of
    :func:`trsm_right_lower_t` transposed — the columns of X are
    independent, so the grid runs over 64-column blocks of B and the
    same substitution walks rows; the loads coalesce along the columns.
    """
    if not _route("trsm_left_lower", b):
        return trsm_left_lower_plain(l, b, unit)
    n, m = b.shape
    _check("trsm_left_lower", n, l, b)
    slate_error_if(tuple(l.shape) != (n, n), "trsm_left_lower dims")
    lc = l.contiguous()
    x = b.clone(memory_format=torch.contiguous_format)
    _launch("slate_trsm_left_lower_f32", b.device, _P(lc.data_ptr()),
            _P(x.data_ptr()), n, m, int(unit))
    LAUNCHES["trsm_left_lower"] += 1
    return x


def trsm_right_lower_t_plain(l: torch.Tensor, b: torch.Tensor,
                             unit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`trsm_right_lower_t`: blocked
    column substitution, 64 columns per block."""
    x = b.clone()
    n = l.shape[0]
    with full_f32_matmul():
        for c0 in range(0, n, BS):
            e = min(n, c0 + BS)
            if c0:
                x[:, c0:e] -= x[:, :c0] @ l[c0:e, :c0].mT
            for c in range(c0, e):
                s = x[:, c] - x[:, c0:c] @ l[c, c0:c]
                x[:, c] = s if unit else s / l[c, c]
    return x


def trsm_left_lower_plain(l: torch.Tensor, b: torch.Tensor,
                          unit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`trsm_left_lower`: the right solve
    on the transpose, as the kernel is."""
    return trsm_right_lower_t_plain(l, b.mT, unit).mT.contiguous()
