"""Hand-written CUDA kernels, their plain versions and their capability
table — the counterpart of ``slate_tpu/internal/pallas_kernels.py`` and
of the Pallas calls of ``slate_tpu/internal/panel_plu.py``.

Each kernel has three parts here:

* a wrapper (``potrf_tile``, ``trsm_right_lower_t``, ``trsm_left_lower``,
  ``panel_plu``, ``panel_fold``, ``panel_unfold``) that launches the
  kernel of ``csrc/`` for a CUDA tensor and counts the launch in
  :data:`LAUNCHES`, runs the plain version for a CPU tensor, and raises
  for anything else. There is no fallback from a failed build or launch;
* a plain PyTorch version (``*_plain``) that repeats the kernel's blocked
  algorithm with torch ops. The CPU runs it, and on the card it is what
  the kernel is checked against;
* a source note on the wrapper: the Pallas function it replaces, what
  bounds it on an H100 and what its design does about that.

The dispatch sites in :mod:`.tile_kernels` consult :data:`CAPABILITY`
(platform → kernel → dtype → (nb_min, nb_max, nb_multiple), modelled on
``pallas_kernels.py:75-114``); what it does not admit goes to the
``torch.linalg`` op, as the JAX package sends it to XLA. For the two
panel kernels the range is that of the panel height h (the JAX
package's ``H_MAX``); the LU kernel's block width is always :data:`W`.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import SlateError, slate_error_if
from .precision import full_f32_matmul

# Column-block width of the kernels (TS in csrc/common.cuh); the plain
# versions block the same way.
BS = 64

# Block width of the panel LU kernel (W in csrc/panel_plu.cu and in
# slate_tpu/internal/panel_plu.py).
W = 128
# Fewest rows one CTA of the panel LU kernel holds (MIN_ROWS in
# csrc/panel_plu.cu); it bounds the grid, hence the scratch, by h / 32.
_PLU_MIN_ROWS = 32

_SPAN = (1, 1024, 1)
_PANEL_SPAN = (1, 16384, 1)
_CAPS_CUDA = {
    "potrf_tile": {"float32": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN},
    "trsm_left_lower": {"float32": _SPAN},
    "panel_plu": {"float32": _PANEL_SPAN},
    "panel_transpose": {"float32": _PANEL_SPAN},
}
_CAPS_CPU = {
    "potrf_tile": {"float32": _SPAN, "float64": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN, "float64": _SPAN},
    "trsm_left_lower": {"float32": _SPAN, "float64": _SPAN},
    "panel_plu": {"float32": _PANEL_SPAN, "float64": _PANEL_SPAN},
    "panel_transpose": {"float32": _PANEL_SPAN, "float64": _PANEL_SPAN},
}
CAPABILITY = {"cuda": _CAPS_CUDA, "cpu": _CAPS_CPU}

# The panel kernels count their launches under the name of the Pallas
# function each call stands for (slate_tpu/internal/panel_plu.py), so
# each TPU kernel shows its own count.
PLU_NAMES = ("plu_call", "plu_call_folded", "plu_call_folded_block")
TRANSPOSE_NAMES = ("transpose_tiled", "transpose_fold", "fold_panel",
                   "unfold_panel", "unfold_transpose")

# Launches of each kernel on the card since the last reset. A wrapper
# adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"potrf_tile": 0, "trsm_right_lower_t": 0, "trsm_left_lower": 0,
            **{k: 0 for k in PLU_NAMES + TRANSPOSE_NAMES}}


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
_L = ctypes.c_longlong
_SIGNATURES = {
    "slate_potrf_tile_f32": ("potrf_tile", (_P, _I, _P, _P)),
    "slate_trsm_right_lower_t_f32": ("trsm_lower", (_P, _P, _I, _I, _I, _P)),
    "slate_trsm_left_lower_f32": ("trsm_lower", (_P, _P, _I, _I, _I, _P)),
    "slate_plu_block_f32": ("panel_plu", (_P,) * 7 + (_I,) * 5 + (_P,)),
    "slate_panel_transpose_f32": ("panel_transpose",
                                  (_P, _P, _I, _I, _I) + (_L,) * 4 + (_P,)),
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


# ---------------------------------------------------------------------------
# K4: pivoting-by-index LU of one 128-column block of a panel
# ---------------------------------------------------------------------------

def _check_panel(kernel: str, name: str, h: int, *ts: torch.Tensor) -> None:
    for t in ts:
        slate_error_if(t.device != ts[0].device or t.dtype != torch.float32
                       or not t.is_contiguous(),
                       f"{name}: the kernel takes contiguous float32 tensors "
                       f"on one CUDA device, got {t.dtype} {tuple(t.shape)} "
                       f"on {t.device}")
    slate_error_if(not supported(kernel, ts[0].dtype, h, ts[0].device),
                   f"{name}: height {h} is outside the capability table")


def panel_plu(buf: torch.Tensor, act: torch.Tensor, blk: int, *,
              name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor columns ``blk·W … blk·W+W−1`` of the segmented column-major
    panel ``buf [S, nb, L]`` (row r at ``(r // L, :, r % L)``, h = S·L)
    in place, pivoting by index against the activity mask ``act`` (S·L
    values, 1 = row may still pivot), which is updated in place too: the
    two are the panel and mask the caller goes on with, so no copy is
    made. Returns ``(piv [W] int32, info)``: ``piv[j]`` is the global row
    of the pivot of column j (h where a NaN left the column without one),
    ``info`` the 0-dim int32 count of zero pivots. ``name`` is the Pallas
    function the call stands for (:data:`PLU_NAMES`), under which the
    launch is counted.

    Replaces ``_plu_kernel`` / ``_plu_kernel_folded``
    (panel_plu.py:88-314) behind ``_plu_call`` (:505, S = 1),
    ``_plu_call_folded`` (:483) and ``plu_call_folded_block`` (:432),
    S = 8. Bound on an H100: latency — 128 dependent column steps, each a
    reduction over all h rows; the bytes (2·h·W·4) and flops (h·W²) are
    a few µs of work. Design (csrc/panel_plu.cu): one cooperative launch,
    one CTA per SM holding its share of the rows in shared memory for
    the whole call; per column one grid barrier, after which every CTA
    reduces the published candidates in the same order and updates its
    own rows. Rows inactive on entry are never written.
    """
    slate_error_if(name not in PLU_NAMES, f"panel_plu: unknown name {name!r}")
    S, nb, L = buf.shape
    h = S * L
    slate_error_if(nb % W != 0 or not 0 <= blk < nb // W or act.numel() != h,
                   f"{name}: panel {tuple(buf.shape)}, block {blk}, mask "
                   f"{tuple(act.shape)} do not fit a [S, nb, L] panel of "
                   f"{W}-column blocks")
    if not _route(name, buf):
        return panel_plu_plain(buf, act, blk)
    _check_panel("panel_plu", name, h, buf, act)
    dev = buf.device
    maxc = -(-h // _PLU_MIN_ROWS)
    cand_s = torch.empty(2 * maxc, dtype=torch.float32, device=dev)
    cand_r = torch.empty(2 * maxc, dtype=torch.int32, device=dev)
    cand_row = torch.empty(2 * maxc * W, dtype=torch.float32, device=dev)
    piv = torch.empty(W, dtype=torch.int32, device=dev)
    info = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("slate_plu_block_f32", dev, *(_P(t.data_ptr()) for t in (
        buf, act, piv, info, cand_s, cand_r, cand_row)), maxc, S, nb, L, blk)
    LAUNCHES[name] += 1
    return piv, info[0]


def panel_plu_plain(buf: torch.Tensor, act: torch.Tensor,
                    blk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`panel_plu`, in place on ``buf``
    and ``act`` the same way: the kernel's eager column loop on an
    [h, W] copy of the block, with the same rounding (reciprocal, then
    product, then difference, one rounding each), so on the same inputs
    it gives the kernel's bits."""
    S, nb, L = buf.shape
    h = S * L
    cols = slice(blk * W, (blk + 1) * W)
    x = buf.new_empty((h, W))                              # a copy
    x.view(S, L, W).copy_(buf[:, cols, :].permute(0, 2, 1))
    a = act.view(h)
    nan = torch.tensor(float("nan"), dtype=buf.dtype, device=buf.device)
    piv = torch.empty(W, dtype=torch.int64, device=buf.device)
    info = torch.zeros((), dtype=torch.int32, device=buf.device)
    for j in range(W):
        col = x[:, j]
        score = torch.where(a > 0, col.abs(), -1.0)
        # max is NaN if any score is; then score >= mx holds nowhere and
        # the column selects no row (piv = h), as in the JAX kernel
        hit = score >= score.max()
        none = ~hit.any()
        r = torch.where(none, h, hit.int().argmax())    # first: lowest row
        rc = r.clamp(max=h - 1)
        u = torch.where(none, nan, x[rc])
        pv = u[j]
        info += (pv == 0).int()
        rsafe = torch.where(pv == 0, 1.0, 1.0 / pv)
        a[rc] = torch.where(none, a[rc], 0.0)
        piv[j] = r
        live = a > 0
        lv = torch.where(live, col * rsafe, col)
        x[:, j] = lv
        rest = x[:, j + 1:]
        x[:, j + 1:] = torch.where(live[:, None],
                                   rest - lv[:, None] * u[None, j + 1:], rest)
    # rows inactive on entry were never changed in x: writing the whole
    # block back leaves their bits as they were
    buf[:, cols, :] = x.reshape(S, L, W).permute(0, 2, 1)
    return piv.int(), info


# ---------------------------------------------------------------------------
# K5: segmented panel transpose
# ---------------------------------------------------------------------------

def panel_fold(x: torch.Tensor, S: int, *, name: str) -> torch.Tensor:
    """[h, w] → segmented column-major [S, w, h/S] with
    ``out[s, c, l] = x[s·(h/S) + l, c]``; a new tensor. ``x`` may be a
    strided window of a larger matrix (unit column stride), which the
    kernel reads in place. ``name`` is the Pallas function the call
    stands for (:data:`TRANSPOSE_NAMES`).

    Replaces ``transpose_tiled`` (panel_plu.py:321, S = 1),
    ``transpose_fold`` (:363) and ``fold_panel`` (:381), S = 8. Bound on
    an H100: bytes, one read and one write of the panel. Design
    (csrc/panel_transpose.cu): a 32×32 tile per CTA through shared
    memory padded to 33 columns; both global sides coalesce.
    """
    slate_error_if(name not in TRANSPOSE_NAMES,
                   f"panel_fold: unknown name {name!r}")
    h, w = x.shape
    slate_error_if(h % S != 0, f"{name}: height {h} is not a multiple of "
                   f"{S} segments")
    if not _route(name, x):
        return panel_fold_plain(x, S)
    slate_error_if(x.dtype != torch.float32 or x.stride(1) != 1,
                   f"{name}: the kernel takes float32 rows of unit column "
                   f"stride, got {x.dtype} with strides {x.stride()}")
    slate_error_if(not supported("panel_transpose", x.dtype, h, x.device),
                   f"{name}: height {h} is outside the capability table")
    L = h // S
    out = torch.empty((S, w, L), dtype=x.dtype, device=x.device)
    _launch("slate_panel_transpose_f32", x.device, _P(x.data_ptr()),
            _P(out.data_ptr()), S, L, w, x.stride(0), L * x.stride(0), L,
            w * L)
    LAUNCHES[name] += 1
    return out


def panel_unfold(xf: torch.Tensor, *, name: str) -> torch.Tensor:
    """Segmented [S, w, L] → [S·L, w], the inverse of :func:`panel_fold`;
    a new tensor. Replaces ``unfold_panel`` (panel_plu.py:401) and
    ``unfold_transpose`` (:419), and ``transpose_tiled`` on the way back
    (S = 1); the same kernel as :func:`panel_fold` with the roles of rows
    and columns swapped."""
    slate_error_if(name not in TRANSPOSE_NAMES,
                   f"panel_unfold: unknown name {name!r}")
    S, w, L = xf.shape
    if not _route(name, xf):
        return panel_unfold_plain(xf)
    _check_panel("panel_transpose", name, S * L, xf)
    out = torch.empty((S * L, w), dtype=xf.dtype, device=xf.device)
    _launch("slate_panel_transpose_f32", xf.device, _P(xf.data_ptr()),
            _P(out.data_ptr()), S, w, L, L, w * L, w, L * w)
    LAUNCHES[name] += 1
    return out


def panel_fold_plain(x: torch.Tensor, S: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`panel_fold`."""
    h, w = x.shape
    return x.reshape(S, h // S, w).permute(0, 2, 1).contiguous()


def panel_unfold_plain(xf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`panel_unfold`."""
    S, w, L = xf.shape
    return xf.permute(0, 2, 1).reshape(S * L, w).contiguous()
