"""Eigenvectors of a symmetric tridiagonal by batched inverse iteration on
the device: the vectors of the steqr path (reference src/steqr2.cc over
dsteqr2.f; counterpart of ``slate_tpu/linalg/stein.py``).

The LAPACK ?stein way, as the JAX package computes it:

* eigenvalues on the host by QR iteration (``eig.sterf``, O(n) memory);
* eigenvectors by inverse iteration, batched over the eigenvalues: all n
  shifted systems (T − λⱼ·I) go through one elimination with 2-row
  partial pivoting (LAPACK dlagtf) and one back-substitution, two sweeps
  with a renormalisation between them — on the card the port's kernel
  K12 (``kernels.stein_iter``), the counterpart of the JAX package's two
  ``lax.scan`` loops;
* close eigenvalues are grouped on the host (LAPACK stein's 1e-3·‖T‖
  rule) and each cluster's columns are re-orthogonalised by one
  ``torch.linalg.qr``, the counterpart of ``jnp.linalg.qr``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..internal import kernels


def _stein_iter_core(dm: torch.Tensor, du: torch.Tensor, lamj: torch.Tensor,
                     X0: torch.Tensor, iters: int) -> torch.Tensor:
    """The batched inverse-iteration sweeps from the start ``X0`` [n, k]
    (stein.py:121-141): K12 on the card, its plain version on the CPU."""
    return kernels.stein_iter(dm, du, lamj, X0, iters)


def shifts(d: np.ndarray, e: np.ndarray, lam: np.ndarray,
           dtype: torch.dtype):
    """The shifts of the n systems: ``lam`` (ascending) with close values
    pulled apart to a spacing of 10·eps·‖T‖ (stein.py:163-172), since
    inverse iteration on equal shifts yields the same vector; the cluster
    QR restores orthogonality. Returns ``(lam_p, tnorm, sep)``."""
    n = d.shape[0]
    tnorm = float(np.abs(d).max() + (np.abs(e).max() if n > 1 else 0.0))
    sep = 10.0 * torch.finfo(dtype).eps * max(tnorm, 1.0)
    lam_p = np.array(lam, np.float64)
    for j in range(1, n):
        if lam_p[j] - lam_p[j - 1] < sep:
            lam_p[j] = lam_p[j - 1] + sep
    return lam_p, tnorm, sep


def stein_vectors(d, e, lam, device=None, dtype=None,
                  iters: int = 2) -> torch.Tensor:
    """Eigenvectors of tridiag(d, e) for the ascending eigenvalues ``lam``
    by batched inverse iteration on ``device`` and one QR per cluster.
    Returns an [n, n] tensor of ``dtype`` (default: d's) on ``device``
    (default: the CUDA card); host memory stays O(n)."""
    d = np.asarray(torch.as_tensor(d).cpu())
    e = np.asarray(torch.as_tensor(e).cpu())
    lam = np.asarray(torch.as_tensor(lam).cpu(), np.float64)
    n = d.shape[0]
    device = torch.device("cuda" if device is None else device)
    zdt = dtype if dtype is not None else torch.as_tensor(d).dtype
    lam_p, tnorm, sep = shifts(d, e, lam, zdt)
    dm = torch.as_tensor(d, dtype=zdt).to(device)
    du = (torch.as_tensor(e, dtype=zdt) if n > 1
          else torch.zeros(0, dtype=zdt)).to(device)
    lamj = torch.as_tensor(lam_p, dtype=zdt).to(device)
    # deterministic start: uniform in [0.5, 1) from a generator seeded 1234
    gen = torch.Generator(device=device).manual_seed(1234)
    X0 = torch.empty((n, n), dtype=zdt, device=device).uniform_(
        0.5, 1.0, generator=gen)
    Z = _stein_iter_core(dm, du, lamj, X0, iters)

    # cluster re-orthogonalisation (host finds groups, one device QR
    # each): LAPACK dstein's rule, eigenvalues closer than 1e-3·‖T‖ share
    # a cluster; the perturbed shifts picked distinct mixtures of the
    # cluster's invariant subspace, and the QR makes them orthonormal
    gtol = 1e-3 * max(tnorm, 1.0)
    bounds = np.nonzero(np.diff(lam) > max(gtol, sep))[0] + 1
    for gidx in np.split(np.arange(n), bounds):
        if len(gidx) < 2:
            continue
        lo, hi = int(gidx[0]), int(gidx[-1]) + 1
        q, _ = torch.linalg.qr(Z[:, lo:hi])
        # keep the inverse-iteration sign convention
        dgn = torch.sign((q * Z[:, lo:hi]).sum(dim=0))
        Z[:, lo:hi] = q * torch.where(dgn == 0, torch.ones_like(dgn), dgn)
    return Z
