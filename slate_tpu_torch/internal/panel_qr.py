"""The QR fast path's panel engine: blocked Householder QR of a tall
panel, 128 columns at a time (counterpart of
``slate_tpu/internal/panel_qr.py``).

A panel of nb columns is factored in W = 128-column subpanels by the
port's kernel K6 (``kernels.panel_qr``, csrc/panel_qr.cu), each from its
own diagonal row d0 = 0, 128, …; between subpanels the rest of the panel
takes the subpanel's compact-WY update C ← C − V·Tᵀ·(Vᵀ·C) as three
matmuls, as the JAX package leaves them to XLA. The output is LAPACK
``geqrf``'s: R on and above the diagonal, the reflectors below, and the
taus.

The JAX package transposes each subpanel to [W, h] and back, a lane
layout for the TPU's vector unit; K6 reads the row-major window of the
panel in place, so there is no transpose here. Unlike the JAX functions,
these update the panel in place.
"""

from __future__ import annotations

import torch

from ..errors import slate_error_if
from . import kernels as K
from .precision import full_f32_matmul
from .tile_kernels import extract_v

W = K.W           # subpanel width
IB = 8            # the JAX kernel's strip width; the port's kernel applies
                  # each reflector eagerly and has no strips
H_MAX = 16384     # tallest subpanel one kernel call takes


def qr_subpanel(sub: torch.Tensor, d0: int):
    """Householder QR of one [h, W] subpanel whose diagonal sits at row
    ``d0`` (rows above it hold finished R rows and are untouched), in
    place. Returns ``(sub, tau [W])``, ``sub`` in LAPACK geqrf layout."""
    h, w = sub.shape
    slate_error_if(w != W or h > H_MAX,
                   f"qr_subpanel: [{h}, {w}] subpanel; expected width {W} "
                   f"and height up to {H_MAX}")
    return sub, K.panel_qr(sub, d0)


def qr_panel_blocked(pan: torch.Tensor):
    """Blocked Householder QR of an [h, nb] panel (nb a multiple of W),
    in place: W-column subpanels through the kernel, the compact-WY
    updates between them as three matmuls at full FP32. Returns
    ``(pan, taus [nb])``, as XLA's ``geqrf`` gives them."""
    from ..linalg.geqrf import _blocked_T
    h, nb = pan.shape
    taus = []
    for c0 in range(0, nb, W):
        subf, tau_s = qr_subpanel(pan[:, c0:c0 + W], c0)
        taus.append(tau_s)
        if c0 + W < nb:
            V = extract_v(subf, c0, h)
            with full_f32_matmul():
                T = _blocked_T(V.mT @ V, tau_s, W, base=8)
                C = pan[:, c0 + W:]              # a view: updates land in pan
                C -= V @ (T.mT @ (V.mT @ C))
    return pan, torch.cat(taus)
