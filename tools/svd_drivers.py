#!/usr/bin/env python3
"""Hold the card's library SVD drivers to two witnesses, on one CUDA card.

    python3 tools/svd_drivers.py [--n 4096] [--n64 8192]

The dense route of ``gesvd`` (Auto below min(m, n) = 12288, and
MethodSVD.Dense) is ``torch.linalg.svdvals`` / ``torch.linalg.svd``, that
is cuSOLVER. For a Hermitian matrix A = (G + Gᴴ)/2 (G Gaussian, complex
parts O(1), the matrix of chip_smoke.py's 3u shim checks) σ = |λ|, so
cuSOLVER's eigensolver in complex128 gives a reference that no SVD
driver shares. Against it the script reads, in complex64 and complex128:

* ``svdvals`` on the card with the default driver and with each of
  ``gesvd`` (QR iteration), ``gesvdj`` (Jacobi) and ``gesvda``;
* ``svdvals`` on the host (LAPACK, the second witness);
* ``svd`` with vectors on the card (default and ``gesvd``): the
  reconstruction ‖A − U·Σ·Vᴴ‖_F/‖A‖_F and ‖UᴴU − I‖_F/n;

each as max|σ − σ_ref|/σ_max beside 10·n·u and its time. Then for a
real Gaussian float64 matrix of order ``--n64`` it times the card's
default and ``gesvd`` drivers and reads their distance to each other.
It prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not readable: {exc}"


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def herm_card(n, seed, dtype):
    g = torch.randn(n, n, generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda", dtype=dtype)
    return (g + g.mH) / 2


def drivers(n: int) -> None:
    for dtype, u in ((torch.complex64, 2.0 ** -24),
                     (torch.complex128, 2.0 ** -53)):
        a = herm_card(n, 137, dtype)
        ref = torch.linalg.eigvalsh(a.to(torch.complex128)).abs() \
            .sort(descending=True).values
        smax = float(ref[0])
        name = str(dtype).removeprefix("torch.")
        print(f"{name} n={n}: Hermitian (G + G^H)/2, sigma_ref = |eigvalsh| "
              f"in complex128 on the card, bound 10*n*u = {10 * n * u:.3e}")

        def read(label, s, ms):
            err = float((s.double().cpu() - ref.cpu()).abs().max()) / smax
            print(f"  {label}: max|s - s_ref|/s_max {err:.3e} "
                  f"({err / u:.1f} u), ms {ms:.1f}")

        for drv in (None, "gesvd", "gesvdj", "gesvda"):
            try:
                s, ms = timed(lambda: torch.linalg.svdvals(a, driver=drv))
            except RuntimeError as exc:
                print(f"  svdvals card driver={drv}: raised {exc}")
                continue
            read(f"svdvals card driver={drv}", s, ms)
        ac = a.cpu()
        t0 = time.perf_counter()
        s = torch.linalg.svdvals(ac)
        read(f"svdvals host LAPACK ({torch.get_num_threads()} threads)", s,
             (time.perf_counter() - t0) * 1e3)
        del ac
        wide = torch.complex128
        a64 = a.to(wide)
        eye = torch.eye(n, device="cuda", dtype=wide)
        for drv in (None, "gesvd"):
            (uu, s, vh), ms = timed(
                lambda: torch.linalg.svd(a, full_matrices=False, driver=drv))
            uu, vh = uu.to(wide), vh.to(wide)
            rec = float(torch.linalg.norm(a64 - (uu * s.double()) @ vh)
                        / torch.linalg.norm(a64))
            orth = float(torch.linalg.norm(uu.mH @ uu - eye) / n)
            read(f"svd card driver={drv}", s, ms)
            print(f"    |A - U S V^H|/|A| {rec:.3e}, |U^H U - I|/n "
                  f"{orth:.3e}")
            del uu, vh
        del a, a64, eye


def real64(n: int) -> None:
    g = torch.randn(n, n, generator=torch.Generator(device="cuda")
                    .manual_seed(135), device="cuda", dtype=torch.float64)
    s0, ms0 = timed(lambda: torch.linalg.svdvals(g))
    s1, ms1 = timed(lambda: torch.linalg.svdvals(g, driver="gesvd"))
    gap = float((s0 - s1).abs().max() / s1[0])
    print(f"float64 Gaussian n={n}: svdvals default ms {ms0:.1f}, "
          f"driver=gesvd ms {ms1:.1f}, max|s_default - s_gesvd|/s_max "
          f"{gap:.3e} ({gap / 2.0 ** -53:.1f} u)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--n64", type=int, default=8192)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    print(card_name())
    drivers(args.n)
    real64(args.n64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
