"""Single-tile dispatch sites (reference include/slate/Tile_blas.hh;
counterpart of ``slate_tpu/internal/tile_kernels.py:61-133``).

Each site sends what :data:`kernels.CAPABILITY` admits to the port's own
kernel (its plain version on the CPU) and everything else to the
matching ``torch.linalg`` op, as the JAX package sends it to XLA.
"""

from __future__ import annotations

import torch

from . import kernels


def _factor_dtype(dt: torch.dtype) -> torch.dtype:
    """Low-precision tiles factor in f32 and cast back (storage precision
    is not panel compute precision)."""
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    return dt


def tile_potrf(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of one [nb, nb] tile → lower factor, upper zeroed. A
    failed factorization yields non-finite entries on the diagonal, as
    XLA's ``cholesky`` does, never an exception."""
    fd = _factor_dtype(a.dtype)
    a32 = a.to(fd)
    if kernels.supported("potrf_tile", fd, a.shape[-1], a.device):
        return kernels.potrf_tile(a32).to(a.dtype)
    l, info = torch.linalg.cholesky_ex(a32)
    return torch.where(info == 0, l, torch.full_like(l, float("nan"))
                       ).to(a.dtype)


def tile_trsm_left_lower(l: torch.Tensor, b: torch.Tensor,
                         unit: bool = False,
                         trans: bool = False) -> torch.Tensor:
    """op(L)⁻¹·B with L lower and op = identity or transpose."""
    if not trans and kernels.supported("trsm_left_lower", l.dtype,
                                       l.shape[0], l.device):
        return kernels.trsm_left_lower(l, b, unit=unit)
    return torch.linalg.solve_triangular(l.mT if trans else l, b,
                                         upper=trans, left=True,
                                         unitriangular=unit)


def tile_trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor,
                            unit: bool = False,
                            conj: bool = False) -> torch.Tensor:
    """B·op(L)⁻¹ with op = (conj-)transpose — the potrf panel op."""
    if not conj and kernels.supported("trsm_right_lower_t", l.dtype,
                                      l.shape[0], l.device):
        return kernels.trsm_right_lower_t(l, b, unit=unit)
    return torch.linalg.solve_triangular(l.mH if conj else l.mT, b,
                                         upper=True, left=False,
                                         unitriangular=unit)
