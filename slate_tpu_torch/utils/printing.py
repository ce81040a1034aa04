"""Matrix printing (reference src/print.cc — verbose levels 0-4 with
corner-tile summaries, Option::PrintVerbose/PrintEdgeItems/PrintWidth/
PrintPrecision; counterpart of ``slate_tpu/utils/printing.py``, whose
text it gives character for character).

Verbose 2 prints an edge summary from the four corner blocks only,
gathered element by element from the tile stack; the full matrix is
never formed (at 64k² it would be 16 GB for a 16-line summary).
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import Op, Option, Uplo, get_option


def _elements(A, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """A[rows, cols] (the outer product of the index sets) gathered from
    the tile stack in one indexing op, as a numpy [len(rows), len(cols)]
    array.

    Shaped matrices store one triangle or band: outside it a Hermitian or
    symmetric matrix is mirrored and a triangular, trapezoid or band one
    prints nan (reference print.cc:423-478); the raw storage there is
    junk."""
    conj = A.op == Op.ConjTrans
    swap = A.op != Op.NoTrans
    R, C = np.meshgrid(np.asarray(rows), np.asarray(cols), indexing="ij")
    I, J = (C, R) if swap else (R, C)
    nb, p, q = A.nb, A.grid.p, A.grid.q

    def fetch(I, J):
        ti, tj = I // nb, J // nb
        idx = [torch.as_tensor(x, device=A.data.device)
               for x in (ti % p, tj % q, ti // p, tj // q, I % nb, J % nb)]
        return A.data[tuple(idx)].cpu().numpy()

    vals = fetch(I, J)
    uplo = getattr(A, "uplo", None)
    name = type(A).__name__
    sig_tri = None
    if uplo in (Uplo.Lower, Uplo.Upper):
        sig_tri = (I >= J) if uplo == Uplo.Lower else (I <= J)
    kl, ku = getattr(A, "kl", None), getattr(A, "ku", None)
    sig_band = None
    if "Band" in name and kl is not None and ku is not None:
        if "Hermitian" in name or "Symmetric" in name:
            # one-sided storage bandwidth; the logical band is symmetric
            bd = max(kl, ku)
            sig_band = (J - I <= bd) & (I - J <= bd)
        else:
            sig_band = (J - I <= ku) & (I - J <= kl)
    if "Hermitian" in name or "Symmetric" in name:
        if sig_tri is not None and not sig_tri.all():
            mirror = fetch(J, I)
            if "Hermitian" in name:
                mirror = np.conj(mirror)
            vals = np.where(sig_tri, vals, mirror)
        if sig_band is not None:   # outside the band the value is 0
            vals = np.where(sig_band, vals, np.zeros_like(vals))
    else:
        if sig_band is not None:
            vals = np.where(sig_band, vals, np.zeros_like(vals))
        if sig_tri is not None and not sig_tri.all():
            vals = np.where(sig_tri, vals, np.full_like(vals, np.nan))
    return np.conj(vals) if conj else vals


def _fmt_block(block: np.ndarray, width: int, prec: int) -> list[str]:
    if np.iscomplexobj(block):
        return [" ".join(
            f"{f'{v.real:.{prec}g}{v.imag:+.{prec}g}j':>{width}}"
            for v in row) for row in block]
    return [" ".join(f"{v:{width}.{prec}g}" for v in row)
            for row in block]


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``float32``, ``complex64``), as
    the JAX package prints its dtypes."""
    return str(dtype).removeprefix("torch.")


def print_matrix(label: str, A, opts=None, file=None) -> str:
    """Render and print a matrix (verbose levels: 0 none, 1 the shape
    banner, 2 a corner summary without a full gather, 3/4 in full).
    Returns the text."""
    verbose = get_option(opts, Option.PrintVerbose, 4)
    edge = get_option(opts, Option.PrintEdgeItems, 16)
    width = get_option(opts, Option.PrintWidth, 10)
    prec = get_option(opts, Option.PrintPrecision, 4)

    lines = [f"% {label}: {type(A).__name__} {A.m}x{A.n} nb={A.nb} "
             f"grid={A.grid.p}x{A.grid.q} dtype={dtype_name(A.dtype)}"]
    small = A.m <= 2 * edge and A.n <= 2 * edge
    if verbose == 2 and not small:
        ridx = (np.arange(min(edge, A.m)),
                np.arange(max(A.m - edge, edge), A.m))
        cidx = (np.arange(min(edge, A.n)),
                np.arange(max(A.n - edge, edge), A.n))
        lines.append(f"{label} = [  %% corner summary, edge={edge}")
        for ri, rows in enumerate(ridx):
            if len(rows) == 0:
                continue
            row_blocks = [_elements(A, rows, c) for c in cidx if len(c)]
            fmt = [_fmt_block(b, width, prec) for b in row_blocks]
            for line_parts in zip(*fmt):
                lines.append("  " + "  ...  ".join(line_parts))
            if ri == 0 and A.m > 2 * edge:
                lines.append("  ...")
        lines.append("]")
    elif verbose >= 2:
        d = A.to_dense().cpu().numpy()
        with np.printoptions(edgeitems=edge, precision=prec,
                             linewidth=max(80, width * 8),
                             threshold=(10**9 if verbose >= 3 else 100)):
            lines.append(f"{label} = [")
            lines.append(str(d))
            lines.append("]")
    out = "\n".join(lines)
    print(out, file=file)
    return out
