#!/usr/bin/env python3
"""Time the tile-Cholesky (K1), left triangular-solve (K3), right
triangular-solve (K2), unpivoted tile-LU (K7), by-index panel-LU (K4),
subpanel-QR (K6), physical-swap panel-LU (K10) and rank-k tail (K11)
kernels and the two bulge chasers (K8, K9) of ``slate_tpu_torch`` on one
CUDA card, beside their plain versions and the one PyTorch call that
computes the same function, and time ``potrf``/``posv`` at the main
path's shape (f32, n=16384, nb=1024, 8 right-hand sides).

    python3 tools/tile_kernel_times.py [--root DIR] [--label NAME] [--sweep]
                                       [--only PARTS]

``--root`` is a checkout of the repository (default: this one) whose
``slate_tpu_torch`` is timed; the rows, times and bounds are those of this
tree's ``chip_smoke.py`` (``potrf_tile_row``, ``trsm_left_row``,
``time_plu``, ``time_ms``), so two trees can be compared on one card in
one command (parent, change, change, parent). K2 runs at
``chip_smoke.py``'s phase-2 shapes with its output printed as a digest
(equal digests: equal bits), and is timed at the 15 panel heights of
``posv`` (B [1024·k, 1024], k = 1 … 15) beside ``solve_triangular``, with
a row of their sums. K4 is timed at its callers' shapes ([8, 1024, 2048]
block 0 of ``gesv``, [8, 128, 2048] of ``plu_panel``, [1, 128, 7424] of
the 8448 ``gesv``) beside ``lu_factor`` (cuSOLVER), and run there on a
random, a tie, a NaN, a zero-column and a half-inactive panel, each
printed as a digest of values, pivots, mask and info. K7 runs at [1024,
1024] (gesv_nopiv's tile), [256, 256] and [200, 200] beside
``lu_factor(pivot=False)``; K10 at hesv's panel heights [16128, 256],
[8192, 256], [2048, 256] and [256, 256] beside ``lu_factor``, with a
digest of its output. K11 runs at gbsv's [32, 96]·[96, 96] and at
[4096, 64]·[64, 4096] beside ``addmm`` (TF32 off) and an empty kernel
(``chip_smoke.empty_launcher``: one CTA of 32 threads) timed by the same
harness: the floor any launch pays. K6 runs at geqrf's [16384, 128]
from d0 = 0, a later subpanel's [13312, 128] from d0 = 896 and gels'
[384, 128] from d0 = 128 beside ``torch.geqrf`` (cuSOLVER), with a digest
of its output. K8 and K9 run at (n, band) = (8192, 128) and (4096, 128)
with a digest of every output (d, e and the reflector packs), so equal
digests mean equal bits. ``--only`` takes a comma-separated subset of
k1k3, k2, k4, k7, k10, k11, k6, chase, posv.
``--sweep`` also times K1, K3 and K7 alone at widths 64 … 1024 (K3 with
8 columns: the time per 64-wide block step) and K3 at n = 1024 over
m = 8 … 256 beside ``solve_triangular``.
Prints one JSON object per line: a row per kernel shape (``ms``,
``plain_ms``, ``library_ms``, ``bound_ms``, ``ratio`` = ``ms /
library_ms``) and one ``posv`` row. Compare ratios only within one
command.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# what --only selects (all by default)
PARTS = ("k1k3", "k2", "k4", "k7", "k10", "k11", "k6", "chase", "posv")


def digest(ts) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)
                          ).hexdigest()[:16]


def dominant_tile(nb, gen):
    """G + nb·I: a tile the unpivoted LU factors without a small pivot."""
    import torch
    return (torch.randn(nb, nb, generator=gen, device="cuda")
            + nb * torch.eye(nb, device="cuda"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts: " + ", ".join(PARTS))
    args = ap.parse_args()
    want = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("tile_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import slate_tpu_torch as st
    from slate_tpu_torch.internal import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def emit(kernel, shape, r):
        b, by = r.pop("bound")
        print(json.dumps(dict(kernel=kernel, shape=shape, **r, bound_ms=b,
                              bound_by=by,
                              ratio=(r["ms"] / r["library_ms"]
                                     if r["library_ms"] else None),
                              label=args.label, device=smi)), flush=True)

    for nb in (1024, 256) if "k1k3" in want else ():
        emit("potrf_tile", [nb, nb],
             cs.potrf_tile_row(cs.spd_tile(nb, gen), plain_reps=3))
    for n, m in ((1024, 8), (256, 8), (1024, 1024)) if "k1k3" in want else ():
        l = cs.lower_factor(n, gen)
        x = torch.randn(n, m, generator=gen, device="cuda")
        emit("trsm_left_lower", [n, m], cs.trsm_left_row(l, x, plain_reps=3))

    if "k2" in want:
        # K2 at chip_smoke's phase-2 shapes: a digest of its output, so two
        # trees can be held to equal bits
        g2 = torch.Generator(device="cuda").manual_seed(2)
        for m, n in ((cs.N - cs.NB, cs.NB), (300, 200)):
            for unit in (False, True):
                l = cs.lower_factor(n, g2, unit)
                b = torch.randn(m, n, generator=g2, device="cuda")
                x = K.trsm_right_lower_t(l, b, unit).cpu().numpy()
                print(json.dumps(dict(
                    kernel="trsm_right_lower_t", shape=[m, n], unit=unit,
                    sha256=hashlib.sha256(x.tobytes()).hexdigest()[:16],
                    label=args.label, device=smi)), flush=True)
        # K2 at the 15 panel heights of posv, beside solve_triangular
        n = cs.NB
        l = cs.lower_factor(n, g2)
        tot = dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
        for k in range(1, cs.N // cs.NB):
            m = k * n
            b = torch.randn(m, n, generator=g2, device="cuda")
            r = cs.trsm_right_row(l, b, plain_reps=1 if m > 4096 else 3)
            for key in tot:
                tot[key] += r[key] if key != "bound_ms" else r["bound"][0]
            emit("trsm_right_lower_t", [m, n], r)
        print(json.dumps(dict(kernel="trsm_right_lower_t_posv_sum",
                              heights=cs.N // cs.NB - 1, **tot,
                              ratio=tot["ms"] / tot["library_ms"],
                              label=args.label, device=smi)), flush=True)
        del b

    if "k4" in want:
        # K4 at its three callers' shapes beside lu_factor, and digests of its
        # output (values, pivots, mask, info) on five kinds of panel there
        for S, L, name in ((8, cs.N // 8, "plu_call_folded_block"),
                           (8, cs.N // 8, "plu_call_folded"),
                           (1, cs.PLU_FLAT_H, "plu_call")):
            nb = cs.NB if name == "plu_call_folded_block" else 128
            for kind in cs.PLU_KINDS:
                buf, act = cs.plu_panel_case(kind, S, nb, L, seed=4)
                kb, ka = buf.clone(), act.clone()
                piv, info = K.panel_plu(kb, ka, 0, name=name)
                sha = hashlib.sha256(b"".join(
                    t.cpu().numpy().tobytes() for t in (kb, ka, piv, info))
                    ).hexdigest()[:16]
                row = dict(kind=kind, sha256=sha, info=int(info))
                if kind == "random":
                    row.update(cs.time_plu(buf, act, 0, name))
                    row["us_per_column"] = row["ms"] / 128 * 1e3
                    emit(f"panel_plu/{name}", [S, nb, L], row)
                else:
                    print(json.dumps(dict(kernel=f"panel_plu/{name}",
                                          shape=[S, nb, L], **row,
                                          label=args.label, device=smi)),
                          flush=True)
                del buf, kb

    if "k7" in want:
        # K7 on G + nb·I (gesv_nopiv's tile at 1024, smaller and ragged ones)
        g7 = torch.Generator(device="cuda").manual_seed(7)
        for nb in (1024, 256, 200):
            emit("lu_nopiv_tile", [nb, nb],
                 cs.lu_nopiv_tile_row(dominant_tile(nb, g7), plain_reps=3))

    if "k10" in want:
        # K10 at hesv's panel heights, with a digest of its output (lu, piv,
        # info) so two trees can be held to equal bits
        g10 = torch.Generator(device="cuda").manual_seed(10)
        for h in (cs.N - cs.AASEN_NB, 8192, 2048, cs.AASEN_NB):
            a = torch.randn(h, cs.AASEN_NB, generator=g10, device="cuda")
            lu, piv, info = K.panel_plu_swap(a)
            sha = hashlib.sha256(lu.cpu().numpy().tobytes()
                                 + piv.cpu().numpy().tobytes()
                                 + info.cpu().numpy().tobytes()).hexdigest()[:16]
            r = cs.swap_row(a, plain_reps=1 if h > 8192 else 3)
            r["us_per_column"] = r["ms"] / cs.AASEN_NB * 1e3
            emit("panel_plu_swap", [h, cs.AASEN_NB], dict(**r, sha256=sha))

    if "k11" in want:
        # K11 beside addmm (TF32 off) and the empty kernel's floor
        empty_ms = cs.time_ms(cs.empty_launcher())
        g11 = torch.Generator(device="cuda").manual_seed(11)
        for m, n, k in ((32, 96, 96), (4096, 4096, 64)):
            c = torch.randn(m, n, generator=g11, device="cuda")
            x = torch.randn(m, k, generator=g11, device="cuda")
            y = torch.randn(k, n, generator=g11, device="cuda")
            with cs._f32():
                lib = cs.time_ms(lambda: torch.addmm(c, x, y, alpha=-1.0))
            emit("rank_k_tail", [m, k, n], dict(
                ms=cs.time_ms(lambda: K.rank_k_tail(c, x, y, -1.0, 1.0)),
                plain_ms=cs.time_ms(lambda: K.rank_k_tail_plain(c, x, y, -1.0,
                                                                1.0)),
                library_ms=lib, empty_ms=empty_ms,
                bound=cs.rank_k_bound(m, n, k),
                sha256=digest([K.rank_k_tail(c, x, y, -1.0, 1.0)])))

    # K6 at geqrf's first and a middle subpanel and gels' short one, with
    # a digest of its output (the window and tau)
    if "k6" in want:
        g6 = torch.Generator(device="cuda").manual_seed(6)
        for h, d0 in cs.QR_SHAPES:
            r = cs.check_qr(h, d0, g6, True)
            a = torch.randn(h, 128, generator=g6, device="cuda")
            tau = K.panel_qr(a, d0)
            r["us_per_column"] = r["ms"] / 128 * 1e3
            emit("panel_qr", [h, 128, d0], dict(**r, sha256=digest([a, tau])))

    if "chase" in want:
        # K8 and K9 at heev's/gesvd's band and half its order, with digests
        g8 = torch.Generator(device="cuda").manual_seed(8)
        for which, fn in (("hb2st", K.hb2st_chase), ("tb2bd", K.tb2bd_chase)):
            for n in (cs.EIG_N, 4096):
                b = cs.EIG_NB
                ab = torch.randn(b + 1, n, generator=g8, device="cuda")
                sha = digest(fn(ab)[:6])
                ms = cs.time_ms(lambda: fn(ab), reps=3)
                S, T = n - 1, (n - 2) // b + 1
                waves = 2 * (S - 1) + T
                emit(which, [n, b], dict(
                    ms=ms, plain_ms=None, library_ms=None, waves=waves,
                    us_per_wave=ms / waves * 1e3, sha256=sha,
                    bound=cs.bound(*cs.chase_work(n, b, which))))
                del ab

    if args.sweep:
        for w in (64, 128, 256, 512, 1024):
            a = cs.spd_tile(w, gen)
            l = cs.lower_factor(w, gen)
            x = torch.randn(w, 8, generator=gen, device="cuda")
            d = dominant_tile(w, gen)
            print(json.dumps(dict(
                kernel="sweep", width=w,
                potrf_tile_ms=cs.time_ms(lambda: K.potrf_tile(a)),
                trsm_left_lower_ms=cs.time_ms(
                    lambda: K.trsm_left_lower(l, x)),
                lu_nopiv_tile_ms=cs.time_ms(lambda: K.lu_nopiv_tile(d)),
                label=args.label, device=smi)), flush=True)
        l = cs.lower_factor(1024, gen)
        for m in (8, 16, 32, 64, 65, 128, 256):
            x = torch.randn(1024, m, generator=gen, device="cuda")
            ms = cs.time_ms(lambda: K.trsm_left_lower(l, x))
            lib = cs.time_ms(lambda: torch.linalg.solve_triangular(
                l, x, upper=False))
            print(json.dumps(dict(
                kernel="sweep_m", shape=[1024, m], ms=ms, library_ms=lib,
                ratio=ms / lib, label=args.label, device=smi)), flush=True)

    if "posv" in want:
        N, NB = cs.N, cs.NB
        grid = st.Grid(1, 1)
        g = torch.randn(N, N, generator=gen, device="cuda")
        with cs._f32():
            a = g @ g.T / N + torch.eye(N, device="cuda")
        del g
        A = st.HermitianMatrix.from_dense(a, nb=NB, grid=grid)
        B = st.Matrix.from_dense(torch.randn(N, cs.NRHS, generator=gen,
                                             device="cuda"), nb=NB, grid=grid)
        st.posv(A, B)
        torch.cuda.synchronize()
        out = {}
        for name, fn in (("potrf_ms", lambda: st.potrf(A)),
                         ("posv_ms", lambda: st.posv(A, B))):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[name] = sorted(ts)[1]
        print(json.dumps(dict(kernel="posv", n=N, nb=NB, nrhs=cs.NRHS, **out,
                              solve_ms=out["posv_ms"] - out["potrf_ms"],
                              label=args.label, device=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
