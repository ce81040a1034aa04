"""Shape buckets: pad-and-crop dispatch into a small set of problem
orders (the port's copy of ``slate_tpu/cache/buckets.py``).

An n×n problem is embedded as ``[[A, 0], [0, I]]`` at the bucket order
N. For an SPD A the embedding stays SPD with the same spectrum (∪ {1});
for partial-pivot LU the zero off-blocks keep the padded rows from ever
winning a pivot search. So ``posv``/``gesv`` on the embedding give the
n-sized answer up to the rounding of another blocking, and the solution
is cropped back to its leading n rows.

``SLATE_TPU_CACHE_BUCKETS=256,512,...`` overrides the table. Orders
above the largest bucket grow to themselves rounded up to a tile
multiple, or are refused (``policy="reject"``).
"""

from __future__ import annotations

import os

import numpy as np

from .. import obs

ENV_BUCKETS = "SLATE_TPU_CACHE_BUCKETS"

DEFAULT_TABLE = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_table() -> tuple[int, ...]:
    """The bucket orders: the env override when it parses to positive
    integers, else :data:`DEFAULT_TABLE`."""
    env = os.environ.get(ENV_BUCKETS, "")
    if not env.strip():
        return DEFAULT_TABLE
    try:
        vals = sorted({int(x) for x in env.replace(";", ",").split(",")
                       if x.strip()})
        if not vals or any(v <= 0 for v in vals):
            raise ValueError(env)
        return tuple(vals)
    except ValueError:
        return DEFAULT_TABLE


def bucket_for(n: int, table=None, nb: int | None = None,
               policy: str = "grow") -> int:
    """The smallest bucket ≥ n. Above the table ``policy`` decides:
    ``"grow"`` gives n rounded up to the next multiple of ``nb`` (or of
    :func:`default_nb`), ``"reject"`` raises :class:`ValueError`."""
    if n <= 0:
        raise ValueError(f"bucket_for: n must be positive, got {n}")
    if policy not in ("grow", "reject"):
        raise ValueError(f"bucket_for: unknown policy {policy!r}")
    table = tuple(table) if table is not None else bucket_table()
    fits = [b for b in table if b >= n]
    if fits:
        return min(fits)
    if policy == "reject":
        raise ValueError(
            f"bucket_for: n={n} exceeds the largest bucket "
            f"{max(table) if table else 0} and policy is 'reject'")
    step = nb or default_nb(n)
    return ((n + step - 1) // step) * step


def default_nb(N: int) -> int:
    """The tile size of a bucket: min(N, 128) up to 512, else 256."""
    return min(N, 128) if N <= 512 else 256


def pad_embed(a, N: int):
    """The dense block-diagonal embedding ``[[a, 0], [0, I]]`` at order N
    (numpy, on the host)."""
    a = np.asarray(a)
    n = a.shape[0]
    if N == n:
        return a
    if N < n:
        raise ValueError(f"bucket {N} smaller than problem {n}")
    out = np.zeros((N, N), dtype=a.dtype)
    out[:n, :n] = a
    idx = np.arange(n, N)
    out[idx, idx] = 1.0
    return out


def pad_rhs(b, N: int):
    """Right-hand sides padded with zero rows to order N, as a 2-D
    array (a 1-D b becomes one column)."""
    b = np.asarray(b)
    b2 = b.reshape(b.shape[0], -1) if b.ndim == 1 else b
    if b2.shape[0] == N:
        return b2
    out = np.zeros((N, b2.shape[1]), dtype=b2.dtype)
    out[:b2.shape[0]] = b2
    return out


def _dispatch(routine: str, a, b, nb, grid, table):
    from ..grid import default_grid
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("bucketed solve expects a square 2-D matrix")
    n = a.shape[0]
    if np.asarray(b).shape[0] != n:
        raise ValueError("rhs rows must match the matrix order")
    N = bucket_for(n, table, nb)
    nb = nb or default_nb(N)
    grid = grid or default_grid()
    obs.count("cache.bucket_dispatch", routine=routine, bucket=str(N),
              padded=("yes" if N != n else "no"))
    return a, n, N, nb, grid


def bucketed_posv(a, b, *, nb: int | None = None, grid=None, opts=None,
                  table=None):
    """SPD solve through the bucket table: pad to the bucket, the port's
    ``posv`` on ``grid`` (``default_grid()`` when None), crop. Returns
    ``(x, info)``: x a tensor on the grid's device with b's ndim, info
    an int."""
    from ..linalg.potrf import posv
    from ..matrix import HermitianMatrix, Matrix
    a, n, N, nb, grid = _dispatch("posv", a, b, nb, grid, table)
    squeeze = np.asarray(b).ndim == 1
    A = HermitianMatrix.from_dense(pad_embed(a, N), nb=nb, grid=grid)
    B = Matrix.from_dense(pad_rhs(b, N), nb=nb, grid=grid)
    X, _, info = posv(A, B, opts)
    x = X.to_dense()[:n]
    return (x[:, 0] if squeeze else x), int(info)


def bucketed_gesv(a, b, *, nb: int | None = None, grid=None, opts=None,
                  table=None):
    """General solve (partial-pivot LU) through the bucket table, with
    :func:`bucketed_posv`'s pad-and-crop contract."""
    from ..linalg.getrf import gesv
    from ..matrix import Matrix
    a, n, N, nb, grid = _dispatch("gesv", a, b, nb, grid, table)
    squeeze = np.asarray(b).ndim == 1
    A = Matrix.from_dense(pad_embed(a, N), nb=nb, grid=grid)
    B = Matrix.from_dense(pad_rhs(b, N), nb=nb, grid=grid)
    X, _, _, info = gesv(A, B, opts)
    x = X.to_dense()[:n]
    return (x[:, 0] if squeeze else x), int(info)
