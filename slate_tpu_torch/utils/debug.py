"""Debug aids (reference src/auxiliary/Debug.{hh,cc} — tile layout
dumps, ``diffLapackMatrices``; counterpart of
``slate_tpu/utils/debug.py``).

The tile store has no MOSI states or lives to dump; what remains
debuggable is geometry (where each tile lives), values (finite? where do
two matrices differ?) and per-tile magnitudes. ``SLATE_TPU_DEBUG=1``
turns on the cheap driver-side input checks, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from ..matrix import BaseTiledMatrix, cdiv
from .printing import dtype_name


def debug_mode() -> bool:
    return os.environ.get("SLATE_TPU_DEBUG", "0") == "1"


def _host(A: BaseTiledMatrix) -> np.ndarray:
    return A.to_dense().cpu().numpy()


def dump_layout(A: BaseTiledMatrix, out=None) -> str:
    """Geometry report: each tile → its grid coordinate and the grid's
    device (analog of Debug::printTilesMaps). Returns the text."""
    g = A.grid
    lines = [f"{type(A).__name__} {A.m}x{A.n} nb={A.nb} grid {g.p}x{g.q}"
             f" op={A.op.name} uplo={A.uplo.name}",
             f"local stack per device: [{A.mtl}, {A.ntl}, {A.nb}, {A.nb}]"
             f" dtype={dtype_name(A.dtype)}"]
    for i in range(min(A.mt, 8)):
        row = [f"({i},{j})->{g.device}" for j in range(min(A.nt, 8))]
        suffix = " …" if A.nt > 8 else ""
        lines.append("  " + " ".join(row) + suffix)
    if A.mt > 8:
        lines.append("  …")
    text = "\n".join(lines)
    print(text, file=out)
    return text


def check_finite(A: BaseTiledMatrix, name: str = "A") -> None:
    """Raise with the first offending element and its tile if A holds a
    non-finite value in its real region (debug-build slate_assert
    analog)."""
    a = _host(A)
    bad = ~np.isfinite(a)
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise FloatingPointError(
            f"{name}[{i},{j}] = {a[i, j]!r} (tile "
            f"({i // A.nb},{j // A.nb})) is not finite")


def diff_matrices(A: BaseTiledMatrix, B: BaseTiledMatrix,
                  tol: float = 0.0, out=None) -> int:
    """Report elementwise differences > tol (reference
    Debug::diffLapackMatrices): prints an [mt, nt] map with '.' for
    clean tiles and '*' for tiles holding a difference; returns the
    number of differing elements."""
    a, b = _host(A), _host(B)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=out)
        return a.size
    d = np.abs(a - b) > tol
    nt_r, nt_c = cdiv(a.shape[0], A.nb), cdiv(a.shape[1], A.nb)
    for i in range(nt_r):
        row = []
        for j in range(nt_c):
            blk = d[i * A.nb:(i + 1) * A.nb, j * A.nb:(j + 1) * A.nb]
            row.append("*" if blk.any() else ".")
        print("".join(row), file=out)
    return int(d.sum())


def tile_norms(A: BaseTiledMatrix) -> np.ndarray:
    """[mt, nt] array of per-tile max-norms (tile-magnitude dump)."""
    a = _host(A)
    out = np.zeros((A.mt, A.nt))
    for i in range(A.mt):
        for j in range(A.nt):
            blk = a[i * A.nb:(i + 1) * A.nb, j * A.nb:(j + 1) * A.nb]
            out[i, j] = np.abs(blk).max() if blk.size else 0.0
    return out
