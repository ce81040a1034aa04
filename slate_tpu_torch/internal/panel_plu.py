"""The LU fast path's subpanel engine: pivoting by index, no row movement
(counterpart of ``slate_tpu/internal/panel_plu.py``).

A subpanel of W = 128 columns is factored with an activity mask instead
of row swaps: the pivot of each column is the active row of largest
magnitude (lowest index on ties), it leaves the mask, and the rows that
stay active take their multipliers and the rank-1 update in place. The
driver (``linalg/getrf.py``) applies the permutation once per group of
panels. The kernels are the port's own (``internal/kernels.py``):
``panel_plu`` (K4) and the segmented transposes ``panel_fold`` /
``panel_unfold`` (K5).

The thin wrappers below carry the names of the JAX package's Pallas
functions, one for each, so every TPU kernel keeps its own launch count.
The port keeps the JAX package's layouts: a flat subpanel is held
transposed, [W, h], and a folded one as [8, W, h/8], row r at
(r // (h/8), :, r % (h/8)). Both are column-major panels, which is also
what the card's kernel wants: each column sweep is a coalesced read. The
driver's flat branch transposes a whole [h, nb] panel once, [nb, h], and
factors its W-row blocks in place, as the folded branch does with its
[8, nb, h/8] buffer.
Unlike the JAX functions, the LU wrappers update the panel and the mask
in place and return only ``(piv, info)``.
"""

from __future__ import annotations

import os

import torch

from ..errors import slate_error_if
from . import kernels as K

W = K.W           # subpanel width
IB = 8            # the JAX kernel's strip width; the port's kernel updates
                  # eagerly and has no strips, kept for the shape contract
H_MAX = 16384     # tallest subpanel one kernel call takes


def _fold_enabled() -> bool:
    """SLATE_LU_FOLD, read at call time (``0`` turns the folded layout
    off)."""
    return os.environ.get("SLATE_LU_FOLD", "1") != "0"


# ---------------------------------------------------------------------------
# the layout kernels (B10–B14)
# ---------------------------------------------------------------------------

def transpose_tiled(x: torch.Tensor, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """[m, k] → [k, m] (B10, panel_plu.py:321), into ``out`` where given
    (a [k, m] window of a larger matrix, unit column stride)."""
    return K.panel_fold(x, 1, name="transpose_tiled",
                        out=None if out is None else out[None])[0]


def transpose_fold(x: torch.Tensor) -> torch.Tensor:
    """[h, W] → folded [8, W, h/8], ``out[s, w, l] = x[s·(h/8)+l, w]``
    (B11, panel_plu.py:363)."""
    return K.panel_fold(x, 8, name="transpose_fold")


def fold_panel(x: torch.Tensor) -> torch.Tensor:
    """[hw, nb] panel → folded [8, nb, hw/8] (B12, panel_plu.py:381);
    ``x`` may be a column window of the dense matrix."""
    return K.panel_fold(x, 8, name="fold_panel")


def unfold_panel(xf: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Folded [8, nb, L] → [8·L, nb], the inverse of :func:`fold_panel`
    (B13, panel_plu.py:401), into ``out`` where given (the panel's window
    of the dense matrix)."""
    return K.panel_unfold(xf, name="unfold_panel", out=out)


def unfold_transpose(xf: torch.Tensor) -> torch.Tensor:
    """Folded [8, W, L] → [8·L, W], the inverse of :func:`transpose_fold`
    (B14, panel_plu.py:419)."""
    return K.panel_unfold(xf, name="unfold_transpose")


# ---------------------------------------------------------------------------
# the subpanel LU (B7–B9), in place on the panel and the mask
# ---------------------------------------------------------------------------

def plu_call_folded_block(pcf: torch.Tensor, act_f: torch.Tensor,
                          sidx: int):
    """Factor W-column block ``sidx`` of a folded panel [8, nb, L] in
    place; ``act_f`` [8, L] is updated in place. Returns
    ``(piv [W] int32, info)`` (B9, panel_plu.py:432)."""
    return K.panel_plu(pcf, act_f, sidx, name="plu_call_folded_block")


def _plu_call_folded(pF: torch.Tensor, act_f: torch.Tensor):
    """The folded [8, W, L] subpanel in place (B8, panel_plu.py:483)."""
    return K.panel_plu(pF, act_f, 0, name="plu_call_folded")


def _plu_call(pT: torch.Tensor, act: torch.Tensor, blk: int = 0):
    """W-column block ``blk`` of a transposed panel [nb, h] in place, and
    the mask ``act`` [h] (B7, panel_plu.py:505: the JAX kernel takes one
    [W, h] subpanel; the port's K4 addresses a block of the whole
    transposed panel, as the folded branch does)."""
    return K.panel_plu(pT[None], act, blk, name="plu_call")


def plu_subpanel(sub: torch.Tensor, act: torch.Tensor, fold=None):
    """Pivoted LU of one [h, W] subpanel, h ≤ H_MAX, h % 8 == 0, by
    index. ``act`` [h] is the activity mask. Returns new tensors
    ``(sub_factored, piv [W] int32, act_new, info)``; neither input is
    changed. Pivot rows keep their U row in place, active rows hold
    multipliers, inactive rows are untouched.

    ``fold`` (default: SLATE_LU_FOLD) takes the folded layout when
    h % 1024 == 0, as the JAX package does (panel_plu.py:530-560)."""
    h, w = sub.shape
    slate_error_if(w != W or h > H_MAX or h % 8 != 0,
                   f"plu_subpanel: [{h}, {w}] subpanel; expected width {W}, "
                   f"height a multiple of 8 up to {H_MAX}")
    if fold is None:
        fold = _fold_enabled()
    act = act.reshape(h).clone()
    if h % 1024 == 0 and fold:
        pF = transpose_fold(sub)
        piv, info = _plu_call_folded(pF, act.view(8, h // 8))
        return unfold_transpose(pF), piv, act, info
    pT = transpose_tiled(sub)
    piv, info = _plu_call(pT, act)
    return transpose_tiled(pT), piv, act, info


def plu_panel(sub: torch.Tensor, act: torch.Tensor, fold=None):
    """Pivoted LU of an [h, W] subpanel for any h, with the contract of
    :func:`plu_subpanel`: one kernel call for h ≤ H_MAX, above it a CALU
    tournament (reference src/getrf_tntpiv.cc; panel_plu.py:563-616)
    over H_MAX-row chunks:

    1. each chunk elects W winner rows with :func:`plu_subpanel` (K4);
    2. the winners' original rows meet in a final :func:`plu_subpanel`
       (only those that are active may pivot), whose LU fixes the pivot
       order and the [W, W] diagonal factor;
    3. every other active row gets its multipliers L = A·U₁₁⁻¹ from one
       ``torch.linalg.solve_triangular``, the counterpart of
       ``lax.linalg.triangular_solve``; the winners' LU rows go to their
       rows (no row moves). A zero on U₁₁'s diagonal is solved against 1
       and its column of multipliers is zero, as the kernel and LAPACK
       leave it.
    """
    h, w = sub.shape
    hmax = H_MAX
    if h <= hmax:
        return plu_subpanel(sub, act, fold=fold)
    nch = -(-h // hmax)
    hp = nch * hmax
    # a padded copy: every chunk is a contiguous [H_MAX, W] block
    subp = sub.new_zeros((hp, w))
    subp[:h] = sub
    actp = act.new_zeros(hp)
    actp[:h] = act.reshape(h)
    winners = []
    for c in range(nch):
        rows = slice(c * hmax, (c + 1) * hmax)
        _, piv_c, _, _ = plu_subpanel(subp[rows], actp[rows], fold=fold)
        winners.append(piv_c.long() + c * hmax)
    wins = torch.cat(winners)                            # [nch·W]
    # a chunk with fewer than W active rows (or a NaN column) selects no
    # row for its last columns (piv = H_MAX); such a slot, and any winner
    # that is not active, stays inactive in the final round. The JAX
    # package marks every candidate active, so a row already eliminated
    # can be elected again there (ROADMAP §C).
    chunk_end = (torch.arange(nch, device=wins.device) + 1).repeat_interleave(
        W) * hmax
    real = wins < chunk_end
    wins = torch.where(real, wins, 0)
    candh = nch * W
    pad_to = max(candh, 8)
    cand = sub.new_zeros((pad_to, w))
    cand[:candh] = subp[wins]                            # original rows
    cact = act.new_zeros(pad_to)
    cact[:candh] = torch.where(real, actp[wins], 0.0)
    final, piv_f, _, info = plu_subpanel(cand, cact, fold=fold)
    piv_f = piv_f.long().clamp_(max=pad_to - 1)
    piv = wins[piv_f]                                    # global rows
    lu_rows = final[piv_f]                               # [W, W] LU
    u11 = lu_rows.triu()
    zero_diag = torch.diagonal(u11) == 0
    safe_u = u11 + torch.diag(zero_diag.to(u11.dtype))
    act_new = actp.clone()
    act_new[piv] = 0.0
    lall = torch.linalg.solve_triangular(safe_u, subp, upper=True,
                                         left=False)
    lall = torch.where(zero_diag[None, :], 0.0, lall)
    out = torch.where((act_new > 0)[:, None], lall, subp)
    out[piv] = lu_rows
    return out[:h], piv.int(), act_new[:h], info
