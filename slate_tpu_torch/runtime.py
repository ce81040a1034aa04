"""Host-side pivot conversions (counterpart of
``slate_tpu/runtime/__init__.py:137-183``).

The JAX package runs these in its C++ runtime when that is built and in
numpy otherwise; the port has no C++ runtime and keeps its own numpy
copies. Both are O(n) on the host and run off the device's stream.
"""

from __future__ import annotations

import numpy as np


def resolve_pivots(piv, nrows: int, forward: bool = True) -> np.ndarray:
    """Sequential swap list → final permutation: ``out[i] = in[perm[i]]``
    after the swaps ``piv`` (0-based, flattened ``[kt, nb]``) are applied
    in order (``forward``) or in reverse (reference makeParallelPivot,
    internal_swap.cc:16-60)."""
    piv = np.asarray(piv, np.int64).reshape(-1)
    perm = np.arange(nrows, dtype=np.int64)
    idx = range(len(piv)) if forward else range(len(piv) - 1, -1, -1)
    for j in idx:
        pv = int(piv[j])
        if 0 <= pv < nrows and j < nrows:
            perm[j], perm[pv] = perm[pv], perm[j]
    return perm


def order_to_ipiv(order) -> np.ndarray:
    """Elimination order → LAPACK ipiv swap list (0-based), int32.

    ``order[j]`` is the original row eliminated at step j, the LU fast
    path's native output. Chain formula: a row is displaced from
    position p exactly when step p swaps it away to ``ipiv[p]``, so
    following each row's displacements until it lands at a position
    ≥ j gives ``ipiv[j]``. Every displacement is consumed by one later
    chain, so the whole conversion is O(n)."""
    order = np.asarray(order, np.int64).reshape(-1)
    n = order.shape[0]
    ipiv = np.empty(n, np.int32)
    for j in range(n):
        p = int(order[j])
        while p < j:
            p = int(ipiv[p])
        ipiv[j] = p
    return ipiv
