"""Test-matrix generation (reference test/matrix_generator.cc:28-71;
counterpart of ``slate_tpu/utils/generator.py``).

The reference generates 26 matrix kinds × singular/eigenvalue
distributions with a counter-based RNG, so that an entry depends on
(seed, i, j) only and not on the process grid (CHANGELOG.md:8-9).

* **Formula kinds** (:data:`FORMULA_KINDS`) are evaluated on the
  matrix's device from global (i, j), straight into the rank-stacked
  tile array; no host matrix is formed. The arithmetic runs in the JAX
  package's precision (f32 for f32/c64 storage, f64 for f64/c128); the
  transcendental terms (sin, cos, powers of ½) are evaluated in f64 and
  rounded to it, so the card and the CPU agree to rounding.
* **Random kinds** (rand/randu, rands, randn, randb, randr) draw from a
  counter-based hash in torch integer ops, keyed by (seed, global tile
  index) as the JAX package folds the tile index into its key: each
  entry is a function of (seed, i, j) alone, so a p×q grid gives the
  bits of Grid(1, 1) (each slot draws the tile at its global index), and
  the card and the CPU give the same bits for the uniform and binary
  kinds (randn's Box–Muller transform runs in f64 and is rounded to f32,
  so it agrees to rounding). ``torch.Generator`` streams differ between the CPU and
  CUDA and cannot give that. The hash is not JAX's threefry, so the
  values differ from the JAX package's; their distributions are the
  same. As in the JAX package, entries are drawn as f32 and cast, so a
  complex random matrix has a zero imaginary part.
* **Structured kinds** (svd, heev, poev/spd) build their orthogonal
  factors on the host with ``numpy.random.default_rng(seed)`` exactly as
  the JAX package does, so they equal its matrices to the dtype's
  rounding.

geev/geevx raise ``NotImplementedError``, as in the reference
(matrix_generator.cc:704-705) and the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import SlateError
from ..grid import Grid, default_grid
from ..internal import masks
from ..matrix import HermitianMatrix, Matrix, cdiv

_M32 = 0xFFFFFFFF
_RANDOM_KINDS = ("rand", "randu", "randn", "rands", "randb", "randr")
_STRUCTURED_KINDS = ("svd", "heev", "poev", "spd")


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The precision formulas run in: f64 for f64/c128, else f32."""
    return torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32


def _default_nb(m: int, grid: Grid) -> int:
    """The JAX package's default tile size (``generator.py:42-43``): the
    rows a rank holds along the longer grid axis, within [8, 256]."""
    return min(256, max(8, m // max(grid.p, grid.q)))


def _grid_geometry(m: int, n: int, nb: int, grid: Grid):
    """``(mtl, ntl, er, ec)``: the local tile counts of an m×n matrix on
    ``grid`` and the global row and column of every element of its
    rank-stacked tile array (broadcastable to ``[p, q, mtl, ntl, nb,
    nb]``)."""
    mtl, ntl = cdiv(cdiv(m, nb), grid.p), cdiv(cdiv(n, nb), grid.q)
    er, ec = masks.grid_elem_index(grid.p, grid.q, mtl, ntl, nb,
                                   grid.device)
    return mtl, ntl, er, ec


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) of the low 32 bits of ``x`` in
    int64 ops; products wrap, and only their low 32 bits are kept."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _draw_bits(seed: int, tile: torch.Tensor, elem: torch.Tensor,
               stream: int) -> torch.Tensor:
    """32 random bits (int64) for element ``elem`` of global tile
    ``tile`` in ``stream``: a counter hashed under a key of (seed,
    tile)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=tile.device)
    key = _mix32(_mix32(s & _M32) ^ _mix32((s >> 32) + 0x9E3779B9) ^ tile)
    return _mix32(_mix32(2 * elem + stream + key) ^ key)


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 bits as an f32 in [0, 1), exactly."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _random_tiles(kind: str, seed: int, er: torch.Tensor, ec: torch.Tensor,
                  nb: int, nt: int) -> torch.Tensor:
    """f32 tiles of a random kind at the global element rows ``er`` and
    columns ``ec``, keyed by each element's global tile."""
    tile = (er // nb) * nt + ec // nb
    elem = (er % nb) * nb + ec % nb
    bits = _draw_bits(seed, tile, elem, 0)
    if kind in ("rand", "randu"):
        return _uniform24(bits)
    if kind == "rands":
        return 2.0 * _uniform24(bits) - 1.0
    if kind == "randb":                    # Dist::Binary {0, 1}
        return (bits >> 31).to(torch.float32)
    if kind == "randr":                    # Dist::BinarySigned {-1, 1}
        return 1.0 - 2.0 * (bits >> 31).to(torch.float32)
    if kind == "randn":                    # Box–Muller, in f64
        u1 = ((bits >> 8) + 1).to(torch.float64) * 2.0 ** -24   # (0, 1]
        u2 = (_draw_bits(seed, tile, elem, 1) >> 8).to(torch.float64) \
            * 2.0 ** -24
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
        return z.to(torch.float32)
    raise SlateError(f"unknown random kind {kind}")


def random_matrix(m: int, n: int, nb: int | None = None,
                  grid: Grid | None = None, dtype=torch.float32,
                  seed: int = 0, kind: str = "randn") -> Matrix:
    """Random matrix on the grid's device; entries depend only on (seed,
    i, j). Drawn as f32 and cast to ``dtype``, as in the JAX package."""
    grid = grid or default_grid()
    nb = nb or _default_nb(m, grid)
    mtl, ntl, er, ec = _grid_geometry(m, n, nb, grid)
    t = _random_tiles(kind, seed, er, ec, nb, cdiv(n, nb))
    data = torch.where((er < m) & (ec < n), t, 0.0).to(_torch_dtype(dtype))
    return Matrix(data=data, m=m, n=n, nb=nb, grid=grid)


# Gallery kinds as elementwise (i, j) formulas (the JAX package's
# ``_formula``): 0-based global i, j; mx = max(m, n).

def _f64(fn, x: torch.Tensor, fd: torch.dtype) -> torch.Tensor:
    """``fn(x)`` evaluated in f64 and rounded to ``fd``."""
    return fn(x.to(torch.float64)).to(fd)


def _formula(kind, i, j, m, n, sigma, fd):
    mx = float(max(m, n))
    fi, fj = i.to(fd), j.to(fd)
    one = torch.ones((), dtype=fd, device=i.device)
    zero = torch.zeros((), dtype=fd, device=i.device)
    if kind == "zeros":
        return torch.zeros_like(fi)
    if kind == "ones":
        return torch.ones_like(fi)
    if kind == "identity":
        return (i == j).to(fd)
    if kind == "jordan":    # ones on the diagonal and the subdiagonal
        return ((i == j) | (i == j + 1)).to(fd)
    if kind == "ij":        # i + j·s with j·s < 1 (matrix_generator.cc:1216)
        s = 10.0 ** (-np.ceil(np.log10(max(n, 2))))
        return (i.to(torch.float64) + j.to(torch.float64) * s).to(fd)
    if kind == "fiedler":
        return (fi - fj).abs()
    if kind == "circul":    # circulant of 1:mx
        d = fj - fi
        return d + torch.where(d < 0, mx * one, zero) + 1.0
    if kind == "gfpp":      # growth-factor worst case
        return torch.where(j == n - 1, one,
                           torch.where(i == j, one,
                                       torch.where(i > j, -0.5 * one,
                                                   zero)))
    if kind == "kms":       # Kac-Murdock-Szegő, rho = 1/2
        return _f64(lambda x: 0.5 ** x, (fi - fj).abs(), fd)
    if kind == "orthog":    # symmetric orthogonal
        c = float(np.sqrt(2.0 / (mx + 1)))
        arg = (fi + 1) * (fj + 1) * (np.pi / (mx + 1))
        return (c * _f64(torch.sin, arg, fd).to(torch.float64)).to(fd)
    if kind == "riemann":   # reference matrix_generator.cc:1509-1535
        bi, bj = i + 3, j + 3
        return torch.where(bi % bj == 0, (bi - 1).to(fd), -one)
    if kind == "ris":       # Hankel, eigenvalues cluster at ±π/2
        return 0.5 / (mx - fi - fj - 0.5)
    if kind == "zielkeNS":  # nonsymmetric Zielke, a = 0
        return torch.where(i < j, one,
                           torch.where((i == max(m, n) - 1) & (j == 0),
                                       -one, zero))
    if kind == "minij":
        return torch.minimum(fi, fj) + 1.0
    if kind == "hilb":
        return 1.0 / (fi + fj + 1.0)
    if kind == "chebspec":  # Chebyshev spectral differentiation D(1:,1:)
        xi = _f64(torch.cos, (np.pi / mx) * (fi + 1), fd)
        xj = _f64(torch.cos, (np.pi / mx) * (fj + 1), fd)
        ci = torch.where(i + 1 == mx, 2.0 * one, one)
        cj = torch.where(j + 1 == mx, 2.0 * one, one)
        sgn = torch.where((i + j) % 2 == 0, one, -one)
        off = sgn * ci / (cj * (xi - xj + (i == j).to(fd)))  # no /0 on diag
        dlast = -(2.0 * mx * mx + 1.0) / 6.0
        dmid = -0.5 * xi / (1.0 - xi * xi)
        return torch.where(i != j, off,
                           torch.where(i + 1 == mx, dlast * one, dmid))
    if kind == "diag":
        sig = sigma.to(fd)
        return torch.where(i == j, sig[torch.clamp(i, max=sig.shape[0] - 1)],
                           zero)
    raise SlateError(f"unknown matrix kind '{kind}'")


FORMULA_KINDS = ("zeros", "ones", "identity", "jordan", "ij", "fiedler",
                 "circul", "gfpp", "kms", "orthog", "riemann", "ris",
                 "zielkeNS", "minij", "hilb", "chebspec", "diag")
# formula kinds returned as a HermitianMatrix when square
_HERMITIAN_FORMULAS = ("kms", "orthog", "ris", "fiedler", "minij", "hilb")


def _dist_values(dist: str, n: int, cond: float) -> np.ndarray:
    """Singular/eigenvalue distributions (matrix_generator.cc:56-71)."""
    i = np.arange(n)
    if dist == "arith":
        s = 1.0 - i / max(n - 1, 1) * (1.0 - 1.0 / cond)
    elif dist == "geo":
        s = cond ** (-i / max(n - 1, 1))
    elif dist == "cluster0":
        s = np.full(n, 1.0 / cond)
        s[0] = 1.0
    elif dist == "cluster1":
        s = np.ones(n)
        s[-1] = 1.0 / cond
    elif dist == "logrand":
        rng = np.random.default_rng(1234)
        s = np.exp(rng.uniform(np.log(1.0 / cond), 0.0, n))
    elif dist == "rarith":
        s = (1.0 - i / max(n - 1, 1) * (1.0 - 1.0 / cond))[::-1].copy()
    elif dist == "rgeo":
        s = (cond ** (-i / max(n - 1, 1)))[::-1].copy()
    elif dist == "rcluster0":
        s = np.full(n, 1.0 / cond)
        s[-1] = 1.0
    elif dist == "rcluster1":
        s = np.ones(n)
        s[0] = 1.0 / cond
    else:
        raise SlateError(f"unknown distribution {dist}")
    return s


def _formula_matrix(kind, m, n, nb, grid, dtype, sigma):
    mtl, ntl, er, ec = _grid_geometry(m, n, nb, grid)
    shape = (grid.p, grid.q, mtl, ntl, nb, nb)
    i, j = er.expand(shape), ec.expand(shape)
    fd = _real_dtype(dtype)
    t = _formula(kind, i, j, m, n, sigma.to(grid.device), fd)
    data = torch.where((er < m) & (ec < n), t, 0.0).to(dtype)
    if kind in _HERMITIAN_FORMULAS and m == n:
        return HermitianMatrix(data=data, m=m, n=n, nb=nb, grid=grid)
    return Matrix(data=data, m=m, n=n, nb=nb, grid=grid)


def generate_matrix(kind: str, m: int, n: int | None = None,
                    nb: int | None = None, grid: Grid | None = None,
                    dtype=torch.float32, seed: int = 0, cond: float = 1e2,
                    dist: str = "logrand", dominant: bool = False):
    """Named test-matrix kinds (reference matrix_generator.cc:28-54), on
    the grid's device. ``dominant`` adds n to the diagonal of the random
    kinds (the reference's ``_dominant`` modifier)."""
    n = n if n is not None else m
    grid = grid or default_grid()
    dtype = _torch_dtype(dtype)
    if kind in ("geev", "geevx"):
        raise NotImplementedError(f"matrix kind '{kind}' — not "
                                  "implemented (matches reference)")
    if kind in _RANDOM_KINDS:
        A = random_matrix(m, n, nb, grid, dtype, seed, kind)
        if dominant:
            from ..ops.elementwise import _add_scaled_identity
            A = _add_scaled_identity(A, float(n))
        return A
    if kind in FORMULA_KINDS:
        sd = _real_dtype(dtype)     # the spectrum at full precision
        sigma = (torch.as_tensor(_dist_values(dist, min(m, n), cond),
                                 dtype=sd)
                 if kind == "diag" else torch.zeros(1, dtype=sd))
        return _formula_matrix(kind, m, n, nb or _default_nb(m, grid),
                               grid, dtype, sigma)
    if kind in _STRUCTURED_KINDS:
        rng = np.random.default_rng(seed)
        if kind == "svd":
            s = _dist_values(dist, min(m, n), cond)
            u, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
            v, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
            a = (u * s) @ v.T
        else:  # heev / poev (spd is the reference's alias for poev)
            lam = _dist_values(dist, m, cond)
            if kind == "heev":
                sgn = np.where(rng.uniform(size=m) < 0.5, -1.0, 1.0)
                lam = lam * sgn
            q, _ = np.linalg.qr(rng.standard_normal((m, m)))
            a = (q * lam) @ q.T
        cls = Matrix if kind == "svd" else HermitianMatrix
        return cls.from_dense(torch.from_numpy(a).to(dtype), nb=nb or 256,
                              grid=grid)
    raise SlateError(f"unknown matrix kind '{kind}'")


def random_spd(n: int, nb: int | None = None, grid: Grid | None = None,
               dtype=torch.float32, seed: int = 0) -> HermitianMatrix:
    """SPD matrix A = G·Gᵀ/n + I on the grid's device from a randn G, by
    ``syrk`` (the p×q SPMD form on a p×q grid); no host matrix."""
    from ..ops.blas import syrk
    from ..ops.elementwise import _add_scaled_identity
    grid = grid or default_grid()
    G = random_matrix(n, n, nb, grid, dtype, seed, "randn")
    C = HermitianMatrix.zeros(n, n, G.nb, grid, dtype=_torch_dtype(dtype))
    C = syrk(1.0 / n, G, 0.0, C)
    C = _add_scaled_identity(C, 1.0)
    return HermitianMatrix(data=C.data, m=n, n=n, nb=G.nb, grid=grid)
