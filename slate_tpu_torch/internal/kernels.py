"""Hand-written CUDA kernels, their plain versions and their capability
table — the counterpart of ``slate_tpu/internal/pallas_kernels.py`` and
of the Pallas calls of ``slate_tpu/internal/panel_plu.py``.

Each kernel has three parts here:

* a wrapper (``potrf_tile``, ``trsm_right_lower_t``, ``trsm_left_lower``,
  ``panel_plu``, ``panel_fold``, ``panel_unfold``, ``panel_qr``,
  ``lu_nopiv_tile``, ``hb2st_chase``, ``tb2bd_chase``, ``panel_plu_swap``,
  ``rank_k_tail``, ``stein_iter``) that launches the
  kernel of ``csrc/`` for a CUDA tensor and counts the launch in
  :data:`LAUNCHES`, runs the plain version for a CPU tensor, and raises
  for anything else. There is no fallback from a failed build or launch;
* a plain PyTorch version (``*_plain``; for the two bulge chasers
  ``band_bulge.hb2st``/``tb2bd``) that repeats the kernel's algorithm
  with torch ops. The CPU runs it, and on the card it is what
  the kernel is checked against;
* a source note on the wrapper: the Pallas function it replaces, what
  bounds it on an H100 and what its design does about that.

The dispatch sites in :mod:`.tile_kernels` consult :data:`CAPABILITY`
(platform → kernel → dtype → (nb_min, nb_max, nb_multiple), modelled on
``pallas_kernels.py:75-114``); what it does not admit goes to the
``torch.linalg`` op, as the JAX package sends it to XLA. For the three
panel kernels the range is that of the panel height h (the JAX
package's ``H_MAX``); the LU and QR kernels' block width is always
:data:`W`. For the two bulge chasers it is the band width; for the
physical-swap panel LU the panel width (its height has its own limit,
:data:`SWAP_H_MAX` on the card); for the rank-k tail the contraction k;
for the batched inverse iteration (K12, which stands for a ``lax.scan``
of ``slate_tpu/linalg/stein.py``, not a Pallas kernel) the order n.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable

import torch

from ..errors import SlateError, slate_error_if
from . import band_bulge
from .precision import TIERS, full_f32_matmul, round_bf16

# Task edge of the dataflow kernels K1, K2, K3 and K7 (BT in
# csrc/dataflow.cuh): K1's and K7's tiles, K2's column blocks and K3's
# block rows; their plain versions block the same way.
BT = 64
# Panel width of K1's and K7's diagonal-block factors (CP in
# csrc/potrf_tile.cu and csrc/lu_nopiv_tile.cu).
_CHOL_PANEL = 16
# Diagonal blocks that K7's inverses start from before they double
# (inv_lu in csrc/lu_nopiv_tile.cu).
_LU_INV_BASE = 16

# Block width of the panel LU kernel (W in csrc/panel_plu.cu and in
# slate_tpu/internal/panel_plu.py).
W = 128
# Fewest rows one CTA of the panel LU kernels holds (MIN_ROWS in
# csrc/panel_plu.cu and csrc/panel_plu_swap.cu).
_PLU_MIN_ROWS = 32

_SPAN = (1, 1024, 1)
_PANEL_SPAN = (1, 16384, 1)
# band widths of the bulge chasers (BMAX in csrc/band_chase.cu); the
# plain versions take any band
_BAND_SPAN = (1, 256, 1)
_ANY_BAND = (1, 1 << 30, 1)
# the chasers' element types: one instantiation each (csrc/chase_flow.cuh)
_CHASE_TYPES = {torch.float32: "f32", torch.float64: "f64",
                torch.complex64: "c64", torch.complex128: "c128"}
_CHASE_CAPS = {str(t).removeprefix("torch."): _BAND_SPAN
               for t in _CHASE_TYPES}
_CHASE_CAPS_CPU = {str(t).removeprefix("torch."): _ANY_BAND
                   for t in _CHASE_TYPES}
# panel widths of the physical-swap panel LU (``_CAPS_TPU["panel_plu"]``
# of pallas_kernels.py) and contractions of the rank-k tail (its
# ``rank_k`` row: below one 128-lane tile)
_SWAP_SPAN = (128, 256, 128)
_RANK_K_SPAN = (1, 127, 1)
# orders of the tridiagonal that the batched inverse iteration takes
_STEIN_SPAN = (1, 1 << 30, 1)
# Tallest panel the physical-swap kernel takes: its rows are spread over
# one CTA per SM in shared memory (csrc/panel_plu_swap.cu), 187 rows of
# 1 KB each at w = 256 on 132 SMs beside the 32 pivot rows of a column
# block; the plain version takes any height.
SWAP_H_MAX = 24576
_CAPS_CUDA = {
    "potrf_tile": {"float32": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN},
    "trsm_left_lower": {"float32": _SPAN},
    "panel_plu": {"float32": _PANEL_SPAN},
    "panel_transpose": {"float32": _PANEL_SPAN},
    "panel_qr": {"float32": _PANEL_SPAN},
    "lu_nopiv_tile": {"float32": _SPAN},
    "hb2st_vmem": _CHASE_CAPS,
    "tb2bd_vmem": _CHASE_CAPS,
    "panel_plu_swap": {"float32": _SWAP_SPAN},
    "rank_k_tail": {"float32": _RANK_K_SPAN},
    "stein": {"float32": _STEIN_SPAN, "float64": _STEIN_SPAN},
}
_CAPS_CPU = {
    "potrf_tile": {"float32": _SPAN, "float64": _SPAN},
    "trsm_right_lower_t": {"float32": _SPAN, "float64": _SPAN},
    "trsm_left_lower": {"float32": _SPAN, "float64": _SPAN},
    "panel_plu": {"float32": _PANEL_SPAN, "float64": _PANEL_SPAN},
    "panel_transpose": {"float32": _PANEL_SPAN, "float64": _PANEL_SPAN},
    "panel_qr": {"float32": _PANEL_SPAN, "float64": _PANEL_SPAN},
    "lu_nopiv_tile": {"float32": _SPAN, "float64": _SPAN},
    "hb2st_vmem": _CHASE_CAPS_CPU,
    "tb2bd_vmem": _CHASE_CAPS_CPU,
    "panel_plu_swap": {"float32": _SWAP_SPAN, "float64": _SWAP_SPAN},
    "rank_k_tail": {"float32": _RANK_K_SPAN, "float64": _RANK_K_SPAN},
    "stein": {"float32": _STEIN_SPAN, "float64": _STEIN_SPAN},
}
CAPABILITY = {"cuda": _CAPS_CUDA, "cpu": _CAPS_CPU}

# The panel kernels count their launches under the name of the Pallas
# function each call stands for (slate_tpu/internal/panel_plu.py), so
# each TPU kernel shows its own count.
PLU_NAMES = ("plu_call", "plu_call_folded", "plu_call_folded_block")
TRANSPOSE_NAMES = ("transpose_tiled", "transpose_fold", "fold_panel",
                   "unfold_panel", "unfold_transpose")

# Launches of each kernel on the card since the last reset. A wrapper
# adds one where it launches its kernel, and nowhere else. The QR kernel,
# the two bulge chasers, the physical-swap panel LU and the rank-k tail
# count under the names of the Pallas functions they stand for
# (``hb2st_vmem``, ``tb2bd_vmem``: one launch per chase); the batched
# inverse iteration counts as ``stein``.
LAUNCHES = {"potrf_tile": 0, "trsm_right_lower_t": 0, "trsm_left_lower": 0,
            **{k: 0 for k in PLU_NAMES + TRANSPOSE_NAMES},
            "qr_call": 0, "lu_nopiv_tile": 0, "hb2st_vmem": 0,
            "tb2bd_vmem": 0, "panel_plu_pallas": 0, "rank_k_tail_pallas": 0,
            "stein": 0}


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
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    "slate_potrf_tile_f32": ("potrf_tile", (_P, _I, _I, _P, _P, _U, _P)),
    "slate_trsm_right_lower_t_f32": ("trsm_lower", (_P, _P, _P, _I, _I, _I, _P,
                                                    _U, _P)),
    "slate_trsm_left_lower_f32": ("trsm_left", (_P, _P, _I, _I, _I, _P, _U,
                                                _P)),
    "slate_plu_block_f32": ("panel_plu", (_P,) * 5 + (_I,) * 6 + (_P,)),
    "slate_panel_transpose_f32": ("panel_transpose",
                                  (_P, _P, _I, _I, _I) + (_L,) * 4 + (_P,)),
    "slate_qr_subpanel_f32": ("panel_qr",
                              (_P, _L, _I, _I, _P, _P, _I, _U, _P)),
    "slate_lu_nopiv_tile_f32": ("lu_nopiv_tile", (_P, _I, _P, _P, _U, _P)),
    **{f"slate_hb2st_{x}": ("hb2st_chase", (_P, _I, _I, _P, _P, _P, _I, _P,
                                            _P))
       for x in _CHASE_TYPES.values()},
    **{f"slate_tb2bd_{x}": ("band_chase", (_P, _I, _I) + (_P,) * 5
                            + (_I, _P, _P))
       for x in _CHASE_TYPES.values()},
    # (band, bytes an element) → scratch elements a CTA; no stream
    "slate_hb2st_scratch": ("hb2st_chase", (_I, _I)),
    "slate_tb2bd_scratch": ("band_chase", (_I, _I)),
    "slate_panel_plu_swap_f32": ("panel_plu_swap", (_P,) * 6 + (_I,) * 3
                                 + (_P,)),
    "slate_rank_k_tail_f32": ("rank_k_tail", (_P, _I, _P, _I, _P, _I, _P)
                              + (_I,) * 3 + (_F, _F, _I, _P)),
    "slate_stein_f32": ("stein_tridiag", (_P,) * 8 + (_I,) * 3 + (_P,)),
    "slate_stein_f64": ("stein_tridiag", (_P,) * 8 + (_I,) * 3 + (_P,)),
}
_FNS: dict = {}


def _entry(symbol: str):
    """One C entry point of the built kernels, loaded once."""
    fn = _FNS.get(symbol)
    if fn is None:
        from ._build import library
        source, argtypes = _SIGNATURES[symbol]
        fn = getattr(library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise if
    it reports a CUDA error."""
    fn = _entry(symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, _P(stream))
    if rc != 0:
        raise SlateError(f"{symbol}: CUDA error {rc} at launch")


# Ready flags of the dataflow kernels K1, K2, K3 and K7, one buffer per
# (device, stream) with the epoch of its last launch: every launch passes
# the next epoch, so the flags need no reset between launches
# (csrc/dataflow.cuh).
# The kernels order a flag against the epoch by their signed difference,
# which is right only while no flag is 2³¹ or more behind: so once the
# epoch reaches EPOCH_RESTART the buffer is zeroed on the stream and the
# epochs start again at 1, and no epoch ever wraps.
_READY: dict = {}
EPOCH_RESTART = 1 << 30


def _ready_flags(device: torch.device, count: int) -> tuple[torch.Tensor, int]:
    """A flag buffer of at least ``count`` entries for a launch on
    ``device``'s current stream, and the launch's epoch (1 … 2³⁰).
    Raises under CUDA graph capture: a replay would repeat the captured
    epoch, which every flag has already reached."""
    slate_error_if(torch.cuda.is_current_stream_capturing(),
                   "the dataflow kernels (potrf_tile, trsm_right_lower_t, "
                   "trsm_left_lower, lu_nopiv_tile) "
                   "cannot be captured in a CUDA graph: each launch needs "
                   "a new epoch for its ready flags")
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ent = _READY.get(key)
    if ent is None or ent[0].numel() < count:
        ent = [torch.zeros(max(count, 1024), dtype=torch.int32, device=device),
               0]
        _READY[key] = ent
    if ent[1] >= EPOCH_RESTART:
        ent[0].zero_()
        ent[1] = 0
    ent[1] += 1
    return ent[0], ent[1]


def _check(kernel: str, nb: int, *ts: torch.Tensor, dims: int = 2) -> None:
    for t in ts:
        slate_error_if(t.device.type != "cuda" or t.dtype != torch.float32
                       or t.dim() != dims,
                       f"{kernel}: the kernel takes {dims}-D float32 CUDA "
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
    """Lower Cholesky factor of one [nb, nb] tile, or of each tile of a
    [batch, nb, nb] stack; the upper triangles come out zeroed. The lower
    triangle of ``a`` is read.

    Replaces ``potrf_tile_pallas`` (pallas_kernels.py:428), which keeps
    the tile in VMEM and, under the JAX package's ``vmap`` of the batched
    drivers, runs once over the whole stack. Bound on an H100: the flops
    (nb³/3, 5 µs of the FP32 rate at nb = 1024) are not; the chain of
    nb/64 dependent diagonal blocks is. Design (csrc/potrf_tile.cu): one
    cooperative launch of a left-looking tile algorithm driven by ready
    flags. The tile stays in global memory (4 MB at nb = 1024, resident
    in L2); each lower 64×64 tile (i, k) is a task that sums
    L[i, j]·L[k, j]ᵀ over j < k as its operands are published, then
    either factors the diagonal block in shared memory (16-column panels,
    each by one warp in registers) and inverts it by recursive doubling,
    or, below the diagonal, multiplies by that inverse's transpose. No
    host loop, launch or grid barrier sits on the chain. A stack is one
    launch too: its batch · ntask tasks run instance-major, each member
    with its own flags and inverse scratch, so the chains of the members
    overlap and a member's bits are those of its own single-tile launch.
    Any nb from 1 to 1024; the ragged last block is masked. A
    non-positive pivot d comes out as NaN on the diagonal (d·rsqrt(d)),
    for the caller's finite guard, in that member only.
    """
    if not _route("potrf_tile", a):
        return potrf_tile_plain(a)
    nb = a.shape[-1]
    slate_error_if(a.dim() not in (2, 3) or a.shape[-2] != nb,
                   "potrf_tile: a square [nb, nb] tile or a [batch, nb, nb] "
                   "stack expected")
    _check("potrf_tile", nb, a, dims=a.dim())
    batch = a.shape[0] if a.dim() == 3 else 1
    out = a.clone(memory_format=torch.contiguous_format)
    if batch == 0:
        return out
    nt = -(-nb // BT)
    inv = torch.empty(batch * nt * BT * BT, dtype=torch.float32,
                      device=a.device)
    flags, epoch = _ready_flags(a.device, batch * nt * (nt + 1) // 2)
    _launch("slate_potrf_tile_f32", a.device, _P(out.data_ptr()), nb, batch,
            _P(inv.data_ptr()), _P(flags.data_ptr()), epoch)
    LAUNCHES["potrf_tile"] += 1
    return out


def _chol_block(d: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a diagonal block (width ≤ :data:`BT`) or of each
    block of a stack, in place, as the kernel's ``chol_block``: 16-column
    panels factored column by column (with r = rsqrt(d) the pivot d·r and
    the column scaled by r, the update kept inside the panel), then the
    trailing block minus the panel's product."""
    w = d.shape[-1]
    for p in range(0, w, _CHOL_PANEL):
        e = min(w, p + _CHOL_PANEL)
        for j in range(p, e):
            r = torch.rsqrt(d[..., j, j])[..., None]
            col = d[..., j + 1:, j] * r
            d[..., j + 1:, j + 1:e] -= (col[..., :, None]
                                        * col[..., None, :e - j - 1])
            d[..., j + 1:, j] = col
            d[..., j, j] = d[..., j, j] * r[..., 0]
        if e < w:
            d[..., e:, e:] -= d[..., e:, p:e] @ d[..., e:, p:e].mT
    return d.tril_()


def _diag_blocks(t: torch.Tensor, q: int) -> torch.Tensor:
    """The q × q diagonal blocks of [..., BT, BT] as a view
    [..., BT/q, q, q]."""
    n = t.shape[-1] // q
    return (t.unflatten(-1, (n, q)).unflatten(-3, (n, q))
             .diagonal(dim1=-4, dim2=-2).movedim(-1, -3))


def _inv_lower_doubling(l: torch.Tensor, unit: bool = False,
                        base: int = 1) -> torch.Tensor:
    """Inverse of a lower-triangular block of width w ≤ :data:`BT` (or of
    each block of a stack) by recursive doubling, as the kernels'
    ``inv_lower`` (csrc/dataflow.cuh): padded to BT with the identity,
    the inverted diagonal first, then at block size s = 1, 2, …, BT/2
    every 2s-block [[A, 0], [C, D]] gets −D⁻¹·(C·A⁻¹) from its two
    inverted s-blocks. ``unit`` takes the diagonal as ones. With ``base``
    > 1 the doubling starts from the inverted base × base diagonal blocks
    (K7's ``inv_lu``)."""
    w = l.shape[-1]
    eye = torch.eye(BT, dtype=l.dtype, device=l.device)
    t = eye.repeat(*l.shape[:-2], 1, 1)
    t[..., :w, :w] = l.tril()
    v = eye.repeat(*l.shape[:-2], 1, 1)
    if base > 1:
        eb = torch.eye(base, dtype=l.dtype, device=l.device)
        for b in range(0, BT, base):
            v[..., b:b + base, b:b + base] = torch.linalg.solve_triangular(
                t[..., b:b + base, b:b + base], eb, upper=False,
                unitriangular=unit)
    elif not unit:
        v[..., :w, :w] = torch.diag_embed(
            1 / torch.diagonal(t, dim1=-2, dim2=-1)[..., :w])
    s = base
    while s < BT:
        q = 2 * s
        tb = _diag_blocks(t, q).contiguous()               # [..., BT/q, 2s, 2s]
        vd = _diag_blocks(v, q)                            # a view of v
        vb = vd.contiguous()
        ca = tb[..., s:, :s] @ vb[..., :s, :s]             # C·A⁻¹
        vd[..., s:, :s] = -(vb[..., s:, s:] @ ca)
        s = q
    return v[..., :w, :w].clone()


def potrf_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`potrf_tile`, on a tile or on a
    stack: the same left-looking algorithm over 64-column blocks — per
    block column the sum of the earlier columns' products, the diagonal
    block's factor, its inverse by recursive doubling, and the panel
    times that inverse's transpose — with the stack on the leading
    axis of every step."""
    a = a.clone()
    nb = a.shape[-1]
    with full_f32_matmul():
        for k0 in range(0, nb, BT):
            e = min(nb, k0 + BT)
            if k0:
                a[..., k0:, k0:e] -= a[..., k0:, :k0] @ a[..., k0:e, :k0].mT
            d = _chol_block(a[..., k0:e, k0:e].clone())
            a[..., k0:e, k0:e] = d
            if e < nb:
                a[..., e:, k0:e] = (a[..., e:, k0:e]
                                    @ _inv_lower_doubling(d).mT)
    return a.tril()


# ---------------------------------------------------------------------------
# K2 / K3: triangular solves against a lower factor
# ---------------------------------------------------------------------------

def trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor,
                       unit: bool = False) -> torch.Tensor:
    """X = B·L⁻ᵀ for lower L [n, n] and B [m, n]; a new tensor.

    Replaces ``trsm_right_lower_t_pallas`` (pallas_kernels.py:613), the
    potrf panel solve (m = 1024 … 15360 rows at n = 1024 on posv). Bound
    on an H100: FP32 operations (m·n² flops on the CUDA cores; at the
    panel [15360, 1024] the bytes are a tenth of that in time), provided
    every SM has work at every m. Design (csrc/trsm_lower.cu): one
    cooperative launch whose tasks are first the n/64 diagonal inverses
    of L (recursive doubling, published once behind ready flags), then
    the tiles (row block r, 64-column block c), each starting from
    B[r, c], subtracting X[r, k]·L[c, k]ᵀ as each X[r, k]'s ready flag
    shows it, and publishing X[r, c] = S·inv(L[c, c])ᵀ; 64-row blocks up
    to m = 4096, 128 above. The products keep 4×4 or 8×4 register tiles,
    read float4 operands from shared memory and stage the next tile pair
    with ``cp.async`` while the current one is multiplied.
    """
    if not _route("trsm_right_lower_t", b):
        return trsm_right_lower_t_plain(l, b, unit)
    m, n = b.shape
    _check("trsm_right_lower_t", n, l, b)
    slate_error_if(tuple(l.shape) != (n, n), "trsm_right_lower_t dims")
    lc = l.contiguous()
    x = b.clone(memory_format=torch.contiguous_format)
    nc = -(-n // BT)
    dinv = torch.empty(nc * BT * BT, dtype=torch.float32, device=b.device)
    flags, epoch = _ready_flags(b.device, nc * (1 + -(-m // BT)))
    _launch("slate_trsm_right_lower_t_f32", b.device, _P(lc.data_ptr()),
            _P(x.data_ptr()), _P(dinv.data_ptr()), m, n, int(unit),
            _P(flags.data_ptr()), epoch)
    LAUNCHES["trsm_right_lower_t"] += 1
    return x


def trsm_left_lower(l: torch.Tensor, b: torch.Tensor,
                    unit: bool = False) -> torch.Tensor:
    """X = L⁻¹·B for lower L [n, n] and B [n, m]; a new tensor.

    Replaces ``trsm_left_lower_pallas`` (pallas_kernels.py:594), here the
    forward solve of one diagonal tile against the real columns of a
    block row: m = nrhs = 8 on posv, gesv, gesv_nopiv, gels LQ and hesv.
    Bound on an H100: the bytes of L at those shapes (2 MB of its lower
    half at n = 1024; the flops are a few µs), but what costs time is the
    chain of n/64 dependent block rows. Design (csrc/trsm_left.cu): one
    cooperative launch whose tasks are (64-row block r, column block c);
    each inverts its diagonal block by recursive doubling at once, sums
    L[r, j]·X[j] as each X[j]'s ready flag shows it, and publishes
    X[r] = inv(L[r, r])·(B[r] − sum). Thin B splits each product's
    contraction over the CTA's threads, so a step of the chain is a flag,
    a short product and the inverse's product.
    """
    if not _route("trsm_left_lower", b):
        return trsm_left_lower_plain(l, b, unit)
    n, m = b.shape
    _check("trsm_left_lower", n, l, b)
    slate_error_if(tuple(l.shape) != (n, n), "trsm_left_lower dims")
    lc = l.contiguous()
    x = b.clone(memory_format=torch.contiguous_format)
    flags, epoch = _ready_flags(b.device, -(-n // BT) * -(-m // 8))
    _launch("slate_trsm_left_lower_f32", b.device, _P(lc.data_ptr()),
            _P(x.data_ptr()), n, m, int(unit), _P(flags.data_ptr()), epoch)
    LAUNCHES["trsm_left_lower"] += 1
    return x


def trsm_right_lower_t_plain(l: torch.Tensor, b: torch.Tensor,
                             unit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`trsm_right_lower_t`: column blocks
    of 64, each X[:, c] = (B[:, c] − X[:, :c]·L[c, :c]ᵀ)·inv(L[c, c])ᵀ
    with the inverse by recursive doubling, as the kernel is."""
    x = b.clone()
    n = l.shape[0]
    with full_f32_matmul():
        for c0 in range(0, n, BT):
            e = min(n, c0 + BT)
            s = x[:, c0:e] - x[:, :c0] @ l[c0:e, :c0].mT if c0 else x[:, c0:e]
            x[:, c0:e] = s @ _inv_lower_doubling(l[c0:e, c0:e], unit).mT
    return x


def trsm_left_lower_plain(l: torch.Tensor, b: torch.Tensor,
                          unit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`trsm_left_lower`: block rows of
    64, each X[r] = inv(L[r, r])·(B[r] − L[r, :r]·X[:r]) with the inverse
    by recursive doubling, as the kernel is."""
    x = b.clone()
    n = l.shape[0]
    with full_f32_matmul():
        for r0 in range(0, n, BT):
            e = min(n, r0 + BT)
            s = x[r0:e] - l[r0:e, :r0] @ x[:r0] if r0 else x[r0:e]
            x[r0:e] = _inv_lower_doubling(l[r0:e, r0:e], unit) @ s
    return x


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
    the whole call. No grid barrier: per column each CTA publishes its
    candidate as one tagged 64-bit word, then that row with the tag on
    every element, and every CTA reduces the G words in the same order.
    The multipliers, column j + 1 and the next search are one pass; the
    rest of the rank-1 update leaves the column's chain: a step updates
    only its 32-column block, and at the block's end each CTA gives its
    rows the block's updates from registers, in the column loop's order
    and roundings (the bits are those of the plain version). Rows
    inactive on entry are never written. The scratch is kept per device
    and stream (:func:`_plu_scratch`).
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
    scratch, ctas, epoch = _plu_scratch(dev)
    piv = torch.empty(W, dtype=torch.int32, device=dev)
    info = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("slate_plu_block_f32", dev, *(_P(t.data_ptr()) for t in (
        buf, act, piv, info, scratch)), ctas, epoch, S, nb, L, blk)
    LAUNCHES[name] += 1
    return piv, info[0]


# Scratch of the kernels whose words carry a tag with the launch's epoch
# (the panel LU kernel K4 and the panel QR kernel K6), one int64 buffer per
# (device, stream) with the epoch of its last launch: nothing of an earlier
# launch is taken for this one's, and the buffer is zeroed before the epoch
# wraps. K4's tags hold 8 bits of epoch, K6's 24.
_PLU_SCRATCH: dict = {}
_PLU_EPOCHS = 255
_QR_SCRATCH: dict = {}
_QR_EPOCHS = (1 << 24) - 1


def _epoch_scratch(table: dict, device: torch.device,
                   words: Callable[[int], int],
                   epochs: int, what: str) -> tuple[torch.Tensor, int, int]:
    """``(words, ctas, epoch)`` for one launch on ``device``'s current
    stream of a kernel on one CTA per SM, ``words(ctas)`` int64 words of
    scratch. Raises under CUDA graph capture: a replay would repeat the
    captured epoch."""
    slate_error_if(torch.cuda.is_current_stream_capturing(),
                   f"{what} cannot be captured in a CUDA graph: each launch "
                   "needs a new epoch for its tags")
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ent = table.get(key)
    if ent is None:
        ctas = torch.cuda.get_device_properties(device).multi_processor_count
        ent = [torch.zeros(words(ctas), dtype=torch.int64, device=device),
               ctas, 0]
        table[key] = ent
    if ent[2] >= epochs:
        ent[0].zero_()
        ent[2] = 0
    ent[2] += 1
    return ent[0], ent[1], ent[2]


def _plu_scratch(device: torch.device) -> tuple[torch.Tensor, int, int]:
    """K4's scratch: 2·ctas·(W + 1) words (:func:`_epoch_scratch`)."""
    return _epoch_scratch(_PLU_SCRATCH, device, lambda c: 2 * c * (W + 1),
                          _PLU_EPOCHS, "the panel LU kernel")


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

def _span(t: torch.Tensor) -> tuple[int, int]:
    """The bytes [lo, hi) a tensor's elements lie in (non-negative
    strides)."""
    lo = t.data_ptr()
    last = sum(max(n - 1, 0) * st for n, st in zip(t.shape, t.stride()))
    return lo, lo + (last + 1) * t.element_size()


def _check_out(name: str, src: torch.Tensor, out: torch.Tensor,
               shape: tuple[int, ...]) -> None:
    """A K5 destination: ``shape`` and ``src``'s dtype and device, unit
    stride along its last axis, the other strides wide enough that no two
    elements share memory, and a memory span apart from ``src``'s (a
    window that interleaves with the source's rows without sharing an
    element is refused as well)."""
    st = out.stride()
    rows_apart = all(st[i] >= st[i + 1] * out.shape[i + 1]
                     for i in range(out.dim() - 1))
    slate_error_if(tuple(out.shape) != shape or out.dtype != src.dtype
                   or out.device != src.device or st[-1] != 1
                   or not rows_apart,
                   f"{name}: the destination must be {shape} {src.dtype} on "
                   f"{src.device} with unit column stride and disjoint rows, "
                   f"got {tuple(out.shape)} {out.dtype} on {out.device} with "
                   f"strides {st}")
    (a0, a1), (b0, b1) = _span(src), _span(out)
    slate_error_if(a0 < b1 and b0 < a1,
                   f"{name}: the destination overlaps the source (their "
                   f"memory spans meet)")


def panel_fold(x: torch.Tensor, S: int, *, name: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """[h, w] → segmented column-major [S, w, h/S] with
    ``out[s, c, l] = x[s·(h/S) + l, c]``. ``x`` may be a strided window
    of a larger matrix (unit column stride), which the kernel reads in
    place. The result goes to ``out`` where given ([S, w, h/S], unit
    stride along its last axis, e.g. ``window[None]`` for S = 1: the
    back transpose of the LU fast path's flat branch writes the panel
    into the dense matrix so), else to a new tensor; it is returned.
    ``name`` is the Pallas function the call stands for
    (:data:`TRANSPOSE_NAMES`).

    Replaces ``transpose_tiled`` (panel_plu.py:321, S = 1),
    ``transpose_fold`` (:363) and ``fold_panel`` (:381), S = 8. Bound on
    an H100: bytes, one read and one write of the panel (0.040 ms at
    [16384, 1024]). Design (csrc/panel_transpose.cu): 64×64 tiles through
    shared memory stored in swizzled 16-byte chunks (neither the row-wise
    fill nor the column-wise drain conflicts), 16-byte cp.async reads and
    16-byte stores of 4×4 blocks transposed in registers; two tiles a
    CTA, the second's reads in flight while it drains the first; element
    by element under a mask where a pointer or a stride is not a multiple
    of 4 floats and at the ragged edge. It runs at the card's copy rate:
    [16384, 1024] takes about what ``Tensor.copy_`` of the same bytes
    takes (PERF.md §6).
    """
    slate_error_if(name not in TRANSPOSE_NAMES,
                   f"panel_fold: unknown name {name!r}")
    h, w = x.shape
    slate_error_if(h % S != 0, f"{name}: height {h} is not a multiple of "
                   f"{S} segments")
    L = h // S
    if out is not None:
        _check_out(name, x, out, (S, w, L))
    if not _route(name, x):
        y = panel_fold_plain(x, S)
        return y if out is None else out.copy_(y)
    slate_error_if(x.dtype != torch.float32 or x.stride(1) != 1,
                   f"{name}: the kernel takes float32 rows of unit column "
                   f"stride, got {x.dtype} with strides {x.stride()}")
    slate_error_if(not supported("panel_transpose", x.dtype, h, x.device),
                   f"{name}: height {h} is outside the capability table")
    if out is None:
        out = torch.empty((S, w, L), dtype=x.dtype, device=x.device)
    _launch("slate_panel_transpose_f32", x.device, _P(x.data_ptr()),
            _P(out.data_ptr()), S, L, w, x.stride(0), L * x.stride(0),
            out.stride(1), out.stride(0))
    LAUNCHES[name] += 1
    return out


def panel_unfold(xf: torch.Tensor, *, name: str,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Segmented [S, w, L] → [S·L, w], the inverse of :func:`panel_fold`,
    into ``out`` where given (an [S·L, w] window of a larger matrix, unit
    column stride: the LU fast path's folded branch writes the panel back
    into the dense matrix so, with no copy after it), else into a new
    tensor; returns it. Replaces ``unfold_panel`` (panel_plu.py:401) and
    ``unfold_transpose`` (:419), and ``transpose_tiled`` on the way back
    (S = 1); the same kernel as :func:`panel_fold` with the roles of rows
    and columns swapped."""
    slate_error_if(name not in TRANSPOSE_NAMES,
                   f"panel_unfold: unknown name {name!r}")
    S, w, L = xf.shape
    if out is not None:
        _check_out(name, xf, out, (S * L, w))
    if not _route(name, xf):
        y = panel_unfold_plain(xf)
        return y if out is None else out.copy_(y)
    _check_panel("panel_transpose", name, S * L, xf)
    if out is None:
        out = torch.empty((S * L, w), dtype=xf.dtype, device=xf.device)
    _launch("slate_panel_transpose_f32", xf.device, _P(xf.data_ptr()),
            _P(out.data_ptr()), S, w, L, L, w * L, out.stride(0),
            L * out.stride(0))
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


# ---------------------------------------------------------------------------
# K6: Householder QR of one 128-column subpanel
# ---------------------------------------------------------------------------

def panel_qr(sub: torch.Tensor, d0: int) -> torch.Tensor:
    """Householder QR of the [h, W] subpanel ``sub`` from diagonal row
    ``d0`` (column j's diagonal is row d0 + j), in place, in LAPACK
    ``geqrf`` layout: R on and above the diagonal, the reflectors' tails
    below it (v₀ = 1 implicit). Rows above ``d0`` hold finished R rows
    and are never read or written. ``sub`` may be a column window of a
    larger row-major matrix (unit column stride), which the kernel reads
    and writes in place. Returns ``tau [W]``.

    Replaces ``_qr_kernel`` behind ``_qr_call`` (panel_qr.py:67-173),
    which holds the subpanel transposed, [W, h], in VMEM. Bound on an
    H100: latency — 128 dependent columns, each a reduction over all rows
    below the diagonal; the bytes (2·h·W·4) and flops (~4·h·W²) are a
    few µs of work. Design (csrc/panel_qr.cu): one cooperative launch of
    one CTA per SM (of 132, 66 and 44 CTAs at [16384, 128] the most is
    the fastest: the pass grows with the rows a CTA holds), each holding
    its band of rows in shared memory for the whole call. The grid barrier and the flat reduction of the design
    it replaced (13.0 µs a column at [16384, 128], 5 of them in the
    exchange) give way to a two-level exchange of tagged words: per
    column each CTA publishes its partial sums s_k = Σ a[i, j]·a[i, k]
    (i below the diagonal, k ≥ j), the owner of column k (CTA k mod G)
    sums the G words of k in a fixed order and publishes s_k, and every
    CTA waits for the s_k and the diagonal row it needs; no grid barrier,
    no fence. Every thread derives α, β, τ, 1/(α − β) and
    τ·vᵀa_k = τ·(a[d, k] + s_k/(α − β)) itself; one pass over its rows,
    one warp a row, writes v, updates the columns right of j and sums
    the next column's partials (3.7 µs a column at [16384, 128]). Each
    reflector is applied eagerly, where the JAX kernel batches IB = 8 of
    them for the MXU; the two agree in exact arithmetic. Runs repeat bit
    for bit. The words live in scratch kept per device and stream
    (:func:`_qr_scratch`), whose tags carry the launch's epoch.
    """
    h, w = sub.shape
    slate_error_if(w != W or not 0 <= d0 < h,
                   f"qr_call: [{h}, {w}] subpanel from row {d0}; expected "
                   f"width {W} and a diagonal row inside it")
    if not _route("qr_call", sub):
        return panel_qr_plain(sub, d0)
    slate_error_if(sub.dtype != torch.float32 or sub.stride(1) != 1,
                   f"qr_call: the kernel takes float32 rows of unit column "
                   f"stride, got {sub.dtype} with strides {sub.stride()}")
    slate_error_if(not supported("panel_qr", sub.dtype, h, sub.device),
                   f"qr_call: height {h} is outside the capability table")
    dev = sub.device
    scratch, ctas, epoch = _qr_scratch(dev)
    tau = torch.empty(W, dtype=torch.float32, device=dev)
    _launch("slate_qr_subpanel_f32", dev, _P(sub.data_ptr()), sub.stride(0),
            h, d0, _P(tau.data_ptr()), _P(scratch.data_ptr()), ctas, epoch)
    LAUNCHES["qr_call"] += 1
    return tau


def _qr_scratch(device: torch.device) -> tuple[torch.Tensor, int, int]:
    """K6's scratch: (2·ctas + 4)·W words (:func:`_epoch_scratch`)."""
    return _epoch_scratch(_QR_SCRATCH, device, lambda c: (2 * c + 4) * W,
                          _QR_EPOCHS, "the panel QR kernel")


def panel_qr_plain(sub: torch.Tensor, d0: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`panel_qr`, in place on ``sub`` the
    same way: the kernel's eager column loop on a copy of the rows from
    ``d0`` down, with vᵀa_k formed from the same sums and v scaled by
    1/(α − β) as LAPACK's ``larfg`` does. Its sums run in another order
    than the kernel's reduction across CTAs, and the kernel fuses the
    rank-1 update's product and difference, so the two agree to
    rounding, not bit for bit."""
    x = sub[d0:].clone()                                   # a copy
    hh = x.shape[0]
    tau = sub.new_zeros(W)
    with full_f32_matmul():
        for j in range(min(W, hh)):
            s = x[j + 1:, j] @ x[j + 1:, j:]               # s[0] = ‖x‖²
            alpha, xnorm2 = x[j, j], s[0]
            trivial = xnorm2 == 0
            sgn = torch.where(alpha < 0, -1.0, 1.0).to(x.dtype)
            beta = torch.where(trivial, alpha,
                               -sgn * torch.sqrt(alpha * alpha + xnorm2))
            t = torch.where(trivial, 0.0, (beta - alpha) / beta).to(x.dtype)
            vden = torch.where(trivial, 1.0, alpha - beta).to(x.dtype)
            rv = 1.0 / vden                   # LAPACK's larfg scales by it
            tw = t * (x[j, j + 1:] + s[1:] * rv)
            x[j + 1:, j] *= rv
            x[j, j] = beta
            x[j, j + 1:] -= tw
            x[j + 1:, j + 1:] -= torch.outer(x[j + 1:, j], tw)
            tau[j] = t
    sub[d0:] = x
    return tau


# ---------------------------------------------------------------------------
# K7: unpivoted tile LU
# ---------------------------------------------------------------------------

def lu_nopiv_tile(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted LU of one [nb, nb] tile, compact: unit-lower L strictly
    below the diagonal, U on and above it; a new tensor. A zero pivot
    keeps its 0 on the U diagonal and the elimination uses 1 in its
    place. Returns ``(lu, info)``, ``info`` the 0-dim int32 count of zero
    diagonal entries of the result.

    Replaces ``lu_nopiv_tile_pallas`` (pallas_kernels.py:442). In the JAX
    package it sits behind the ``tile`` rung, off by default
    (tile_kernels.py:71-80, :308-311), as B1 does; the port sends it
    whatever :data:`CAPABILITY` admits on the card, as it does for
    :func:`potrf_tile`. Bound on an H100: the flops (2nb³/3, 11 µs of
    the FP32 rate at nb = 1024) are not; the chain of nb/64 dependent
    diagonal blocks is. Design (csrc/lu_nopiv_tile.cu), K1's: one
    cooperative launch of a left-looking tile algorithm driven by ready
    flags. The tile stays in global memory (4 MB at nb = 1024, resident
    in L2); each 64×64 tile (i, k) is a task that sums L[i, j]·U[j, k]
    over j < min(i, k) as its operands are published, then either
    factors the diagonal block in shared memory (16-column panels, each
    by one warp in registers) and inverts its unit L and safe U (16×16
    blocks by one warp each, then recursive doubling), or multiplies by
    one of those inverses: L[i, k] = (A − Σ)·U⁻¹ below the diagonal,
    U[i, k] = L⁻¹·(A − Σ) above. No host loop, launch or grid barrier
    sits on the chain. Any nb from 1 to 1024; the ragged last block is
    masked.
    """
    if not _route("lu_nopiv_tile", a):
        return lu_nopiv_tile_plain(a)
    nb = a.shape[-1]
    _check("lu_nopiv_tile", nb, a)
    slate_error_if(a.shape[0] != nb, "lu_nopiv_tile: square tile expected")
    out = a.clone(memory_format=torch.contiguous_format)
    nt = -(-nb // BT)
    inv = torch.empty(nt * 2 * BT * BT, dtype=torch.float32, device=a.device)
    flags, epoch = _ready_flags(a.device, nt * nt)
    _launch("slate_lu_nopiv_tile_f32", a.device, _P(out.data_ptr()), nb,
            _P(inv.data_ptr()), _P(flags.data_ptr()), epoch)
    LAUNCHES["lu_nopiv_tile"] += 1
    return out, (torch.diagonal(out) == 0).sum().int()


def _lu_block(d: torch.Tensor) -> torch.Tensor:
    """Unpivoted LU of a diagonal block (width ≤ :data:`BT`), in place,
    as the kernel's ``lu_block``: 16-column panels factored column by
    column (the multipliers times the reciprocal of the pivot, 1 in
    place of a zero one; the update kept inside the panel), then the
    panel's U rows right of it, L11⁻¹·A12 by forward substitution, and
    the trailing block minus L21·U12."""
    w = d.shape[0]
    for p in range(0, w, _CHOL_PANEL):
        e = min(w, p + _CHOL_PANEL)
        for j in range(p, e):
            piv = d[j, j]
            r = 1 / torch.where(piv == 0, 1.0, piv).to(d.dtype)
            col = d[j + 1:, j] * r
            d[j + 1:, j + 1:e] -= torch.outer(col, d[j, j + 1:e])
            d[j + 1:, j] = col
        if e < w:
            for q in range(p, e):
                d[q + 1:e, e:] -= torch.outer(d[q + 1:e, q], d[q, e:])
            d[e:, e:] -= d[e:, p:e] @ d[p:e, e:]
    return d


def _inv_upper_safe_doubling(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular block (width ≤ :data:`BT`) whose zero
    diagonal entries are taken as 1, as the kernel forms it: the
    doubling inverse (:func:`_inv_lower_doubling`, from 16×16 blocks) of
    the lower block Uᵀ, transposed."""
    u = u.triu()
    d = torch.diagonal(u)
    u = u - torch.diag(d) + torch.diag(torch.where(d == 0, 1.0, d).to(u.dtype))
    return _inv_lower_doubling(u.mT, base=_LU_INV_BASE).mT


def lu_nopiv_tile_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lu_nopiv_tile`: the same
    left-looking algorithm over 64-column blocks — per block the sums of
    the earlier blocks' products in its L column and U row, the diagonal
    block's factor, the inverses of its unit L and safe U (16×16 blocks,
    then recursive doubling), and the products of the L column with U⁻¹
    and of L⁻¹ with the U row."""
    a = a.clone()
    nb = a.shape[0]
    with full_f32_matmul():
        for k0 in range(0, nb, BT):
            e = min(nb, k0 + BT)
            if k0:
                a[k0:, k0:e] -= a[k0:, :k0] @ a[:k0, k0:e]
                a[k0:e, e:] -= a[k0:e, :k0] @ a[:k0, e:]
            d = _lu_block(a[k0:e, k0:e].clone())
            a[k0:e, k0:e] = d
            if e < nb:
                a[e:, k0:e] = a[e:, k0:e] @ _inv_upper_safe_doubling(d)
                a[k0:e, e:] = _inv_lower_doubling(
                    d, unit=True, base=_LU_INV_BASE) @ a[k0:e, e:]
    return a, (torch.diagonal(a) == 0).sum().int()


# ---------------------------------------------------------------------------
# K8 / K9: bulge chasers (band → tridiagonal, band → bidiagonal)
# ---------------------------------------------------------------------------

def _trivial_band(name: str, ab: torch.Tensor) -> bool:
    """Raise for what the chase kernel does not take; True for the
    trivial case (band < 1 or n < 2), which is the function itself and
    launches nothing."""
    slate_error_if(ab.dtype not in _CHASE_TYPES,
                   f"{name}: the kernel takes float32, float64, complex64 "
                   f"and complex128 bands, got {ab.dtype}")
    band, n = ab.shape[0] - 1, ab.shape[1]
    if band < 1 or n < 2:
        return True
    slate_error_if(not supported(name, ab.dtype, band, ab.device),
                   f"{name}: band {band} is outside the kernel's "
                   f"{_BAND_SPAN[0]}..{_BAND_SPAN[1]}")
    return False


def _chase_scratch(chase: str, b: int, ctas: int, dtype,
                   device) -> torch.Tensor:
    """Global scratch for the task blocks of ``chase`` ("hb2st" or
    "tb2bd") at band ``b`` in ``dtype``: as many elements a CTA as the
    kernel's own ``slate_<chase>_scratch`` asks (two [b, b|1] blocks
    where they do not fit its shared memory, csrc/chase_flow.cuh); one
    element when they do."""
    item = torch.empty((), dtype=dtype).element_size()
    per = _entry(f"slate_{chase}_scratch")(b, item)
    return torch.empty(max(1, per * ctas), dtype=dtype, device=device)


def hb2st_chase(ab: torch.Tensor):
    """Hermitian band (lower storage ``ab[d, j] = A[j+d, j]``) → real
    tridiagonal; the contract of :func:`band_bulge.hb2st`,
    ``(d, e, V [S, T, b], tau [S, T])``, in float32, float64, complex64
    or complex128 (one instantiation of csrc/hb2st_chase.cu each; the JAX
    package runs the last three through its XLA wave, not a Pallas
    kernel).

    Replaces ``_hb2st_vmem_jit`` (band_wave_vmem.py:492), which keeps the
    whole ribbon in VMEM across a sequential grid of waves and works on
    sheared blocks with masked rolls and one-hot MXU moves. What it
    computes is the twin's task DAG: task (sweep s, chase t) needs the
    reflector of (s, t − 1) and the elements that (s − 1, t) and
    (s − 1, t + 1) wrote last. Bound on an H100: latency along the ~2n
    dependent task parts of the chain (a sweep trails the one before it
    by about two tasks); the flops (~16·b² a task, 1.0 ms at n = 8192,
    b = 128) and the bytes are far below it. Design (csrc/hb2st_chase.cu
    on the persistent loop of csrc/chase_flow.cuh): one cooperative
    launch for the whole chase. CTA x takes the sweeps x, x + G, …; a
    task loads and right-applies all but the last row of its blocks once
    (s − 1, t) is done, goes on with the last row once (s − 1, t + 1)
    has stored its bulge, and reads D's last diagonal element once
    (s − 1, t + 1) is done. The counters it waits on are zeroed by this
    wrapper for every call (no epoch). A task keeps only the lower
    triangle (no mirror store), runs each pass one warp a row with
    shuffle reductions in a fixed order, so runs repeat bit for bit, and
    updates D by one matvec and one Hermitian rank-2 update, the form of
    :func:`band_bulge.hb2st`. The blocks sit in shared memory while their
    two [b, b|1] blocks take at most 160 KiB (float32 bands up to 143,
    float64 and complex64 up to 101, complex128 up to 71) and in global
    scratch up to 256, sized by the kernel's ``slate_hb2st_scratch``.
    The 4b-wide ribbon stays in device memory (17 MB at n = 8192,
    b = 128, resident in L2). A CPU
    tensor runs the plain version; a band < 1 or n < 2 is the trivial
    case."""
    band, n = ab.shape[0] - 1, ab.shape[1]
    if not _route("hb2st_vmem", ab):
        return band_bulge.hb2st(ab)
    if _trivial_band("hb2st_vmem", ab):
        return band_bulge.hb2st(ab)
    slate_error_if(torch.cuda.is_current_stream_capturing(),
                   "hb2st_chase cannot be captured in a CUDA graph: its "
                   "ribbon is built by boolean indexing, which waits for "
                   "the host")
    S, T = n - 1, band_bulge.max_chase(n, band)
    rib = band_bulge.ribbon(ab.contiguous(), upper=False)
    V = ab.new_zeros((S, T, band))
    tau = ab.new_zeros((S, T))
    ctas = torch.cuda.get_device_properties(ab.device).multi_processor_count
    scratch = _chase_scratch("hb2st", band, ctas, ab.dtype, ab.device)
    cnt = torch.zeros(2 * S, dtype=torch.int32, device=ab.device)
    _launch(f"slate_hb2st_{_CHASE_TYPES[ab.dtype]}", ab.device,
            _P(rib.data_ptr()), n, band,
            _P(V.data_ptr()), _P(tau.data_ptr()), _P(scratch.data_ptr()),
            ctas, _P(cnt.data_ptr()))
    LAUNCHES["hb2st_vmem"] += 1
    d, e = band_bulge.ribbon_diagonals(rib, n, band, upper=False)
    return d, e, V, tau


def tb2bd_chase(ub: torch.Tensor):
    """Upper triangular band (``ub[d, j] = A[j, j+d]``) → real upper
    bidiagonal; the contract of :func:`band_bulge.tb2bd`,
    ``(d, e, Vu, tauu, Vv, tauv, phase0)``, in the four types of
    :func:`hb2st_chase`. The column-0 phase is
    :func:`band_bulge.phase0`, a torch op on the ribbon's (0, 0) before
    the launch, so it equals the plain version's.

    Replaces ``_tb2bd_vmem_jit`` (band_wave_vmem_bd.py:330), the SVD twin
    of the eig chaser. Same bound as :func:`hb2st_chase`: latency along
    the ~2n dependent task parts of the chain. Design (csrc/band_chase.cu
    on the persistent loop of csrc/chase_flow.cuh, K8's): one cooperative
    launch for the whole chase, CTA x taking the sweeps x, x + G, …, so
    the U-side reflector that chains task (s, t − 1) to (s, t) stays in
    the CTA's shared memory. A task loads its bulge block B and its whole
    diagonal block D (whose lower part holds the fill the next sweep
    chases) but B's last element and D's last column once (s − 1, t) is
    done, and left-applies the previous U-side reflector to all of B's
    columns but the last; once (s − 1, t + 1) has stored its bulge it
    takes those, forms the V-side reflector from B's row 0 and
    right-applies it to B's rows (stored) and, after publishing, to D's
    rows; once (s − 1, t + 1) is done it takes D's last diagonal element,
    forms the U-side reflector from D's column 0 and left-applies it. The
    counters it waits on are zeroed by this wrapper for every call (no
    epoch). Every pass runs one warp a row with shuffle reductions in a
    fixed order, so runs repeat bit for bit; the arithmetic is
    :func:`band_bulge.tb2bd`'s. The blocks sit in shared memory or in
    global scratch as :func:`hb2st_chase`'s. At n = 8192, b = 128 a
    chase takes 166 ms, against 680 in the design of one launch per wave
    it replaced (41.5 µs a wave, block moves and four full-block passes
    per task); a task's loads lead its 20 µs. A CPU tensor runs the
    plain version; a band < 1 or n < 2 is the trivial case."""
    band, n = ub.shape[0] - 1, ub.shape[1]
    if not _route("tb2bd_vmem", ub):
        return band_bulge.tb2bd(ub)
    if _trivial_band("tb2bd_vmem", ub):
        return band_bulge.tb2bd(ub)
    slate_error_if(torch.cuda.is_current_stream_capturing(),
                   "tb2bd_chase cannot be captured in a CUDA graph: its "
                   "ribbon is built by boolean indexing, which waits for "
                   "the host")
    S, T = n - 1, band_bulge.max_chase(n, band)
    rib = band_bulge.ribbon(ub.contiguous(), upper=True)
    phase0 = band_bulge.phase0(rib, band)
    Vu, Vv = ub.new_zeros((S, T, band)), ub.new_zeros((S, T, band))
    tauu, tauv = ub.new_zeros((S, T)), ub.new_zeros((S, T))
    ctas = torch.cuda.get_device_properties(ub.device).multi_processor_count
    scratch = _chase_scratch("tb2bd", band, ctas, ub.dtype, ub.device)
    cnt = torch.zeros(2 * S, dtype=torch.int32, device=ub.device)
    _launch(f"slate_tb2bd_{_CHASE_TYPES[ub.dtype]}", ub.device,
            _P(rib.data_ptr()), n, band,
            *(_P(t.data_ptr()) for t in (Vu, tauu, Vv, tauv, scratch)),
            ctas, _P(cnt.data_ptr()))
    LAUNCHES["tb2bd_vmem"] += 1
    d, e = band_bulge.ribbon_diagonals(rib, n, band, upper=True)
    return d, e, Vu, tauu, Vv, tauv, phase0


# ---------------------------------------------------------------------------
# K10: partial-pivot panel LU with physical row swaps
# ---------------------------------------------------------------------------

def panel_plu_swap(a: torch.Tensor):
    """Partial-pivot LU of a rows-at-origin [h, w] panel with physical
    row swaps: ``(lu, piv [min(h, w)] int32, info)``, ``lu`` a new tensor
    holding unit-lower L strictly below the diagonal and U on and above
    it, ``piv[j]`` the position swapped with position j at step j (LAPACK
    sequential ipiv, 0-based; h where a NaN left column j without a
    pivot), ``info`` the 0-dim int32 count of zero pivots. Column j takes
    the largest |a[i, j]| over positions i ≥ j, a tie going to the lowest
    current position (LAPACK isamax); whole rows move, the L columns
    already factored included; the multipliers divide by the pivot, by 1
    in place of a zero one.

    Replaces ``panel_plu_pallas`` (pallas_kernels.py:508, body
    ``_panel_plu_kernel`` :464-504), which extracts each column with a
    masked sum and swaps rows by selecting over the whole [h, w] window,
    Mosaic having no dynamic indexing. Bound on an H100: latency — w
    dependent column steps, each a reduction over all h rows and a row
    exchange; the bytes (2·h·w·4) and flops (h·w²) are tens of µs of
    work. Design (csrc/panel_plu_swap.cu): one cooperative launch, one
    CTA per SM holding its band of positions in shared memory; per column
    each CTA publishes its winner as one 64-bit word, then that row (and
    the holder of position j row j) with the column's tag on every
    element, waits for the other CTAs' words (no grid barrier, no memory
    fence), reduces them in the same order (ties to the lower position),
    the holders of j and of the winner exchange the two rows, and every
    CTA forms its multipliers and updates column j + 1 before it
    publishes the next candidate. The rest of the rank-1
    update leaves the column's chain: a step updates only its 32-column
    block, and at the block's end each CTA applies the block's 32 updates
    to its rows' trailing columns from registers, in the column loop's
    order and roundings (the result is bitwise that of the plain
    version).
    """
    h, w = a.shape
    if not _route("panel_plu_pallas", a):
        return panel_plu_swap_plain(a)
    _check("panel_plu_swap", w, a)
    slate_error_if(h > SWAP_H_MAX, f"panel_plu_swap: height {h} is above the "
                   f"kernel's {SWAP_H_MAX}")
    dev = a.device
    lu = a.clone(memory_format=torch.contiguous_format)
    # one CTA per SM at most (csrc/panel_plu_swap.cu)
    maxc = min(-(-h // _PLU_MIN_ROWS),
               torch.cuda.get_device_properties(dev).multi_processor_count)
    # candidate words and published rows, zeroed: an entry is ready once
    # it carries its column's tag, so none of an earlier call may be left
    cand = torch.zeros(2 * maxc * (w + 1) + 2 * w, dtype=torch.int64,
                       device=dev)
    cand_row = cand[2 * maxc:2 * maxc * (w + 1)]
    row_j = cand[2 * maxc * (w + 1):]
    piv = torch.empty(min(h, w), dtype=torch.int32, device=dev)
    info = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("slate_panel_plu_swap_f32", dev, *(_P(t.data_ptr()) for t in (
        lu, piv, info, cand, cand_row, row_j)), maxc, h, w)
    LAUNCHES["panel_plu_pallas"] += 1
    return lu, piv, info[0]


def panel_plu_swap_plain(a: torch.Tensor):
    """Plain PyTorch version of :func:`panel_plu_swap`: the JAX kernel's
    column loop with the row exchange by index, the full rank-1 update of
    the [h, w] panel (so a non-finite factor spreads NaN as IEEE
    arithmetic spreads it there) and the same rounding as the kernel (a
    true division per multiplier, then a product and a difference)."""
    x = a.clone()
    h, w = x.shape
    dev = x.device
    pos = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    piv = torch.empty(min(h, w), dtype=torch.int32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    zero = x.new_zeros(w)
    for j in range(min(h, w)):
        colv = x[:, j].clone()
        score = torch.where(pos >= j, colv.abs(), -1.0)
        # max is NaN if any score is; then score >= mx holds nowhere and no
        # row is selected (r = h)
        hits = (score >= score.max()).nonzero()
        r = int(hits[0, 0]) if hits.numel() else h
        rowr = x[r].clone() if r < h else zero
        rowj = x[j].clone()
        vr = colv[r].clone() if r < h else colv.new_zeros(())
        if r < h:
            x[r] = rowj
            colv[r] = colv[j]
        x[j] = rowr
        colv[j] = vr
        info += (vr == 0).int()
        safe = torch.where(vr == 0, 1.0, vr)
        lcol = torch.where(pos > j, colv / safe, 0.0)
        urow = torch.where(cols > j, rowr, 0.0)
        x -= torch.outer(lcol, urow)
        x[j + 1:, j] = lcol[j + 1:]
        piv[j] = r
    return x, piv, info


# ---------------------------------------------------------------------------
# K11: rank-k tail
# ---------------------------------------------------------------------------

def rank_k_tail(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                alpha: float = -1.0, beta: float = 1.0,
                tier: str = "bf16_6x") -> torch.Tensor:
    """α·A·B + β·C with k = a.shape[1] in 1…127, the product at ``tier``;
    a new tensor. Any m and n.

    Replaces ``rank_k_tail_pallas`` (pallas_kernels.py:644, body
    ``_rank_k_kernel`` :635-640), the sub-nb remainder of a trailing
    update, which runs its contraction at the caller's tier. Bound on an
    H100: bytes at large shapes (k/4 flops a byte at most, against a
    ridge of ~20), latency at the band LU's [32, 96]·[96, 96], a launch
    in a loop of 171. Design (csrc/rank_k_tail.cu): a tiled SIMT product
    whose C tile is chosen by shape: 16×32 tiles for small outputs (6
    CTAs at [32, 96], none past m), 64×64 tiles with 4×4 micro-tiles
    otherwise; every CTA starts its C loads and its A and B strips'
    loads (float4 where aligned) before it uses any, and one fused α/β
    epilogue writes the output. One accumulator per output, k ascending,
    so the bits do not depend on the tile. The tiers: ``mxu_bf16``
    rounds A and B to bf16 (to nearest even) as they are staged in
    shared memory, then runs the same FP32 FMA loop; ``bf16_3x`` and
    ``bf16_6x`` run the FP32 body, the cheapest way on CUDA cores to
    meet 2⁻¹⁸.
    """
    m, k = a.shape
    n = b.shape[1]
    slate_error_if(tuple(c.shape) != (m, n) or b.shape[0] != k,
                   f"rank_k_tail dims: C {tuple(c.shape)}, A {tuple(a.shape)}, "
                   f"B {tuple(b.shape)}")
    slate_error_if(tier not in TIERS, f"rank_k_tail: unknown tier {tier!r}")
    if not _route("rank_k_tail_pallas", c):
        return rank_k_tail_plain(c, a, b, alpha, beta, tier)
    _check("rank_k_tail", k, c, a, b)
    out = torch.empty((m, n), dtype=c.dtype, device=c.device)
    if m == 0 or n == 0:
        return out
    c, a, b = (t if t.stride(1) == 1 else t.contiguous() for t in (c, a, b))
    _launch("slate_rank_k_tail_f32", c.device, _P(c.data_ptr()), c.stride(0),
            _P(a.data_ptr()), a.stride(0), _P(b.data_ptr()), b.stride(0),
            _P(out.data_ptr()), m, n, k, float(alpha), float(beta),
            int(tier == "mxu_bf16"))
    LAUNCHES["rank_k_tail_pallas"] += 1
    return out


def rank_k_tail_plain(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      alpha: float = -1.0, beta: float = 1.0,
                      tier: str = "bf16_6x") -> torch.Tensor:
    """Plain PyTorch version of :func:`rank_k_tail`: the Pallas kernel's
    ``alpha * (A @ B) + beta * C`` with the product in full FP32, its
    operands rounded to bf16 first at ``mxu_bf16`` (f32 operands; an f64
    product keeps its operands)."""
    if tier == "mxu_bf16" and a.dtype == torch.float32:
        a, b = round_bf16(a), round_bf16(b)
    with full_f32_matmul():
        return alpha * (a @ b) + beta * c


# ---------------------------------------------------------------------------
# K12: batched tridiagonal inverse iteration
# ---------------------------------------------------------------------------

_STEIN_SYMBOLS = {torch.float32: "slate_stein_f32",
                  torch.float64: "slate_stein_f64"}


def stein_iter(dm: torch.Tensor, du: torch.Tensor, lam: torch.Tensor,
               x0: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """``iters`` sweeps of inverse iteration on the k systems
    (T − lam_j·I)·x_j = b_j of the symmetric tridiagonal T = (dm [n],
    du [n − 1]) from the columns of ``x0`` [n, k], each sweep followed by
    a max-renormalisation of every column; then every column at unit
    2-norm with its largest entry positive. A new [n, k] tensor of x0's
    dtype (float32 or float64).

    Stands for the ``lax.scan`` loops that XLA runs on the device in the
    JAX package (``_solve_batch`` and ``_stein_iter_core``,
    slate_tpu/linalg/stein.py:49-141), not for a Pallas kernel. Bound on
    an H100: the bytes of the [n, k] arrays, and below them the chain of
    n dependent rows each system walks a pass. Design
    (csrc/stein_tridiag.cu): one thread a system, the elimination with
    2-row partial pivoting (LAPACK dlagtf) in registers, the fill rows in
    [n, k] arrays with k contiguous (coalesced), each row's inputs loaded
    one step ahead; every step one IEEE operation in the plain version's
    order, so up to the final 2-norm the result is the plain version's
    bit for bit. A back-substitution that overflows (a pivot replaced by
    4·FLT_MIN, where the JAX package's column turns to NaN) is run again
    with R scaled by 2⁻⁶⁴, up to three times; the renormalisation removes
    the scale.
    """
    n, k = x0.shape
    slate_error_if(dm.shape != (n,) or du.shape != (max(n - 1, 0),)
                   or lam.shape != (k,),
                   f"stein_iter dims: d {tuple(dm.shape)}, e "
                   f"{tuple(du.shape)}, lam {tuple(lam.shape)}, X0 "
                   f"{tuple(x0.shape)}")
    if not _route("stein", x0):
        return stein_iter_plain(dm, du, lam, x0, iters)
    dt = x0.dtype
    slate_error_if(dt not in _STEIN_SYMBOLS or not supported(
        "stein", dt, n, x0.device), f"stein_iter: no kernel for {dt}")
    for t in (dm, du, lam):
        slate_error_if(t.device != x0.device or t.dtype != dt,
                       "stein_iter: d, e, lam and X0 must share a CUDA "
                       "device and a dtype")
    dmc, duc, lamc = (t.contiguous() for t in (dm, du, lam))
    x = x0.clone(memory_format=torch.contiguous_format)
    fill = torch.empty((4, n, k), dtype=dt, device=x0.device)
    _launch(_STEIN_SYMBOLS[dt], x0.device, *(_P(t.data_ptr()) for t in (
        dmc, duc if n > 1 else dmc, lamc, x, *fill)), n, k, int(iters))
    LAUNCHES["stein"] += 1
    return x


def _stein_solve_plain(dm, du, lam, b):
    """(T − lam_j·I)·x_j = b_j for every column j: the row loop of
    ``_solve_batch`` (stein.py:49-118), one row at a time over [k]
    vectors."""
    n, k = b.shape
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    a = dm[0] - lam
    if n == 1:
        return (b[0] / torch.where(a == 0, one, a))[None]
    bb = du[0].expand(k)
    c = torch.zeros(k, dtype=b.dtype, device=b.device)
    r = b[0]
    U = torch.empty_like(b)
    V = torch.empty_like(b)
    Wf = torch.empty_like(b)
    R = torch.empty_like(b)
    for i in range(1, n):
        dui = du[i] if i < n - 1 else zero
        dli = du[i - 1]
        an = dm[i] - lam
        swap = dli.abs() > a.abs()
        pa = torch.where(swap, dli, a)
        pb = torch.where(swap, an, bb)
        pc = torch.where(swap, dui, c)
        pr = torch.where(swap, b[i], r)
        qa = torch.where(swap, a, dli)
        qb = torch.where(swap, bb, an)
        qc = torch.where(swap, c, dui)
        qr = torch.where(swap, r, b[i])
        m = torch.where(pa == 0, zero, qa / torch.where(pa == 0, one, pa))
        U[i - 1], V[i - 1], Wf[i - 1], R[i - 1] = pa, pb, pc, pr
        a = qb - m * pb
        bb = qc - m * pc
        c = torch.zeros_like(c)
        r = qr - m * pr
    U[n - 1], V[n - 1], Wf[n - 1], R[n - 1] = a, zero, zero, r
    tiny = torch.tensor(float(torch.finfo(torch.float32).tiny) * 4,
                        dtype=b.dtype, device=b.device)
    U = torch.where(U.abs() < tiny, torch.where(U < 0, -tiny, tiny), U)
    x = _stein_back_plain(U, V, Wf, R)
    # a column that overflows is solved again from R scaled by 2^-64, up
    # to three times (the kernel's rule)
    scale = one
    for _ in range(3):
        bad = ~torch.isfinite(x).all(dim=0)
        if not bool(bad.any()):
            break
        scale = scale * 2.0 ** -64
        xs = _stein_back_plain(U[:, bad], V[:, bad], Wf[:, bad],
                               R[:, bad] * scale)
        x[:, bad] = xs
    return x


def _stein_back_plain(U, V, Wf, R):
    """x_i = (r_i − v_i·x_{i+1} − w_i·x_{i+2}) / u_i, bottom row first."""
    n, k = R.shape
    x = torch.empty_like(R)
    x1 = torch.zeros(k, dtype=R.dtype, device=R.device)
    x2 = torch.zeros_like(x1)
    for i in range(n - 1, -1, -1):
        xi = (R[i] - V[i] * x1 - Wf[i] * x2) / U[i]
        x[i] = xi
        x1, x2 = xi, x1
    return x


def stein_iter_plain(dm: torch.Tensor, du: torch.Tensor, lam: torch.Tensor,
                     x0: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Plain PyTorch version of :func:`stein_iter`: ``_stein_iter_core``
    (stein.py:121-141) with the row loop of ``_solve_batch``."""
    x = x0
    for _ in range(iters):
        x = _stein_solve_plain(dm, du, lam, x)
        s = x.abs().amax(dim=0, keepdim=True)
        x = x / torch.where(s == 0, torch.ones_like(s), s)
    nrm = torch.sqrt((x * x).sum(dim=0, keepdim=True))
    x = x / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    imax = x.abs().argmax(dim=0)
    sgn = torch.sign(x[imax, torch.arange(x.shape[1], device=x.device)])
    return x * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[None, :]
