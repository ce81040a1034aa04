"""The schedule of the by-index panel LU kernel K4 (csrc/panel_plu.cu),
modelled on the host and held bit for bit to ``panel_plu_plain``.

K4 defers the trailing part of each column's rank-1 update: columns go in
blocks of IB = 32, a step updates only its block's columns, and at the
block's end every row takes the block's updates of the steps at which it
was still active, in the column loop's order, from the pivot rows'
trailing parts formed by the same sequential updates. A published pivot
row carries exact block columns and stale trailing ones. The model below
repeats that order with the kernel's roundings (a product, then a
difference, one rounding each), so it must give the eager loop's bits on
every panel: random, ties, NaN, Inf, a zero column and inactive rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slate_tpu_torch.internal import kernels as K
import tests.torch_cpu_threads  # noqa: E402,F401

W = K.W
IB = 32


def deferred_plu(buf: torch.Tensor, act: torch.Tensor, blk: int):
    """K4's schedule on copies of (buf, act): returns (buf, act, piv,
    info) as the kernel leaves them."""
    buf, act = buf.clone(), act.clone()
    S, nb, L = buf.shape
    h = S * L
    cols = slice(blk * W, (blk + 1) * W)
    x = buf[:, cols, :].permute(0, 2, 1).reshape(h, W).clone()
    a = act.view(h)
    a0 = a.clone()
    piv = torch.empty(W, dtype=torch.int32)
    info = 0
    nan = torch.tensor(float("nan"))
    for j0 in range(0, W, IB):
        jc = j0 + IB
        # updates each row takes at the block's end: all IB while active,
        # those before its pivot step if it pivots, none if inactive
        d = torch.where(a > 0, IB, 0)
        ub = torch.empty(IB, W)
        for j in range(j0, jc):
            jb = j - j0
            score = torch.where(a > 0, x[:, j].abs(), -1.0)
            none = bool(torch.isnan(score).any())
            if none:
                r = h
                ub[jb] = nan
            else:
                r = int((score == score.max()).int().argmax())
                ub[jb] = x[r]          # block columns exact, trailing stale
                if a[r] > 0:           # else no row is active: r is row 0
                    d[r] = jb
                a[r] = 0.0
            u = ub[jb]
            pv = u[j]
            info += int(pv == 0)
            rsafe = torch.where(pv == 0, 1.0, 1.0 / pv)
            piv[j] = r
            live = a > 0
            x[live, j] = x[live, j] * rsafe
            lv = x[live, j:j + 1]
            x[live, j + 1:jc] = x[live, j + 1:jc] - lv * u[None, j + 1:jc]
        if jc == W:
            break
        # the pivot rows' trailing parts: row t takes steps j0 … t-1
        t_rows = ub[:, jc:].clone()
        for q in range(IB):
            for t in range(q + 1, IB):
                t_rows[t] = t_rows[t] - ub[t, j0 + q] * t_rows[q]
        # every row: the block's updates in order, up to its own count
        for q in range(IB):
            rows = d > q
            x[rows, jc:] = (x[rows, jc:]
                            - x[rows, j0 + q:j0 + q + 1] * t_rows[q][None])
    keep = (a0 > 0).view(S, L, 1)
    old = buf[:, cols, :].permute(0, 2, 1)
    new = torch.where(keep, x.view(S, L, W), old)
    buf[:, cols, :] = new.permute(0, 2, 1)
    return buf, act, piv, torch.tensor(info, dtype=torch.int32)


def panel(kind, S, nb, L, seed):
    rng = np.random.default_rng(seed)
    h = S * L
    if kind == "tie":
        b = rng.integers(-3, 4, (S, nb, L)).astype(np.float32)
    else:
        b = rng.standard_normal((S, nb, L)).astype(np.float32)
    kill = 0.5 if kind == "inactive" else 0.18
    a = (rng.random(h) >= kill).astype(np.float32)
    live = np.flatnonzero(a)
    if kind == "inactive":
        b = np.where((a == 0).reshape(S, 1, L), 100 * b, b)
    elif kind == "zero_column":
        b[:, 3::W, :] = 0.0
    elif kind in ("nan", "inf"):
        r = live[len(live) // 3]
        b[r // L, 9::W, r % L] = np.nan if kind == "nan" else np.inf
    return torch.from_numpy(b), torch.from_numpy(a)


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """NaN at the same places and every other bit equal."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(
        x.masked_fill(nx, 0).view(torch.int32),
        y.masked_fill(ny, 0).view(torch.int32)))


@pytest.mark.parametrize("kind", ["random", "tie", "nan", "inf",
                                  "zero_column", "inactive"])
@pytest.mark.parametrize("S,nb,L,blk", [
    (8, 256, 40, 1),      # folded, h = 320, the second block
    (1, 128, 300, 0),     # flat
    (1, 128, 90, 0),      # fewer rows than columns: steps with none active
])
def test_deferred_schedule_matches_plain_bitwise(kind, S, nb, L, blk):
    buf, act = panel(kind, S, nb, L, seed=S * L + blk)
    mb, ma, mpiv, minfo = deferred_plu(buf, act, blk)
    pb, pa = buf.clone(), act.clone()
    ppiv, pinfo = K.panel_plu_plain(pb, pa, blk)
    assert torch.equal(mpiv, ppiv)
    assert torch.equal(ma, pa)
    assert int(minfo) == int(pinfo)
    assert same_bits(mb, pb)
    if kind == "zero_column":
        assert int(pinfo) >= 1
    if kind == "nan":
        assert int(ppiv[9]) == S * L
