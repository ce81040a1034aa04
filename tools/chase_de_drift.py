#!/usr/bin/env python3
"""How far the d and |e| of the band → tridiagonal chase (K8) and the
band → bidiagonal chase (K9) drift between two correct computations, as
the order n grows, on one CUDA card.

    python3 tools/chase_de_drift.py [--sizes 512,1024,2048] [--band 64]

``chip_smoke.py`` holds the kernels' d and |e| to their plain versions
on the card within ``CHASE_DE_TOL``·‖A‖₂·u/2⁻²⁴, a limit that does not
grow with n. For each dtype (float32, float64), each n and one seeded
random band [band + 1, n], this script runs K8 (and, in float64 at the
largest n, K9) on the card, and the plain version on the card and on
the CPU: the same code in other summation orders. It prints the max
abs difference of d and |e| (``chip_smoke.de_gap``) for kernel − plain
(card), plain (card) − plain (CPU) and kernel − plain (CPU), each in
units of u·‖A‖₂ beside the limit in the same units, and the spectra of
the three against the dense band's in f64 (``chip_smoke.spectrum``), in
units of n·u·‖A‖₂. Prints one JSON object per line, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048")
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chase_de_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from slate_tpu_torch.internal import band_bulge as bb
    from slate_tpu_torch.internal import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    sizes = [int(s) for s in args.sizes.split(",")]
    b = args.band
    cases = [("hb2st", dt, n) for dt in (torch.float32, torch.float64)
             for n in sizes] + [("tb2bd", torch.float64, max(sizes))]
    for which, dtype, n in cases:
        upper = which == "tb2bd"
        fn = K.tb2bd_chase if upper else K.hb2st_chase
        plain = bb.tb2bd if upper else bb.hb2st
        gen = torch.Generator(device="cuda").manual_seed(args.seed + n)
        ab = torch.randn(b + 1, n, generator=gen, device="cuda", dtype=dtype)
        out = fn(ab)
        card = plain(ab)
        cpu = plain(ab.cpu())
        want = cs.spectrum(cs.dense_band(ab, upper), upper, gram=False)
        norm2 = float(want.abs().max())
        u = cs.unit_roundoff(dtype)
        unit = u * norm2

        def spec_gap(r):
            d, e = (t.to("cuda") for t in r[:2])
            got = (cs.chase_spectrum(d, e, upper, True)
                   if dtype == torch.float32
                   else cs.tridiag_spectrum(d, e, upper))
            return float((got - want).abs().max()) / (n * unit)

        print(json.dumps(dict(
            chase=which, dtype=str(dtype)[6:], n=n, band=b,
            norm2=norm2,
            kernel_vs_plain_card_u=cs.de_gap(out, card) / unit,
            plain_card_vs_plain_cpu_u=cs.de_gap(card, cpu) / unit,
            kernel_vs_plain_cpu_u=cs.de_gap(out, cpu) / unit,
            limit_u=cs.CHASE_DE_TOL * 2.0 ** 24,
            spectrum_nu=dict(kernel=spec_gap(out), plain_card=spec_gap(card),
                             plain_cpu=spec_gap(cpu)),
            device=smi)), flush=True)
        del ab, out, card, cpu
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
