#!/usr/bin/env python3
"""Time the tile-Cholesky (K1), left triangular-solve (K3), right
triangular-solve (K2), unpivoted tile-LU (K7), by-index panel-LU (K4),
subpanel-QR (K6), physical-swap panel-LU (K10) and rank-k tail (K11)
kernels and the two bulge chasers (K8, K9) of ``slate_tpu_torch`` on one
CUDA card, beside their plain versions and the one PyTorch call that
computes the same function, and time ``potrf``/``posv`` at the main
path's shape (f32, n=16384, nb=1024, 8 right-hand sides).

    python3 tools/tile_kernel_times.py [--root DIR] [--label NAME] [--sweep]
                                       [--only PARTS] [--out DIR]

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
digests mean equal bits. ``chase_drift`` holds K8's and K9's reflectors
(V and τ) at the short chains (n, band) = (12, 1), (50, 8), (40, 64) of
``tests/test_torch_gpu.py::test_chase_kernels_match_plain`` to the plain
version run in f64 on the card, at the test's seed and seven more: the
kernel's largest distance from it beside the f32 plain version's on the
card and on the CPU, and the backward error of each (the band rebuilt
from d, e and the reflectors). K5 runs at its callers' shapes (B10
``transpose_tiled`` at [8448, 128] both ways and at the whole [8448, 256]
panel window both ways, B11 [16384, 128], B12 a [16384, 1024] window, B13
[8, 1024, 2048], B14 [8, 128, 2048]) beside ``permute().contiguous()``,
with a digest of its output, and where the checkout's K5 takes a
destination, writing into a column window of a wider matrix. ``lu_prof``
runs one ``gesv`` at n = 8448, nb = 256 (the flat branch) and one at
16384/1024 (the folded one) under ``torch.profiler`` and prints every
device kernel by name with its launches and time (as JSON files into
``--out DIR`` where given), the K5 launches' mean
device time, and the copy and elementwise kernels' count. ``pbsv_prof``
runs one ``pbsv`` at ``chip_smoke.py`` 3r's shape (f32, n = 16384,
kd = 32, 8 right-hand sides) under ``torch.profiler`` and prints
``chip_smoke.phase_breakdown``'s lines: wall and device busy time, the
device time by category and the six host ops with the most self time;
before it, the median of 7 timed runs (``pbsv_ms``).
``lu_gate`` times ``gesv`` (f32, 8 right-hand sides) at n = 20480, 24576
and 32768, nb = 512 (the LAPACK shims' default there) and 1024, on the
dense route (SLATE_LU_FAST=0: ``lu_factor`` per panel) and on the
default one (the pivoting-by-index fast path, CALU above 16384 rows),
in the order dense, fast, fast, dense, dense, fast after a warm-up of
each (the median of three a route), with ``info`` and the backward
error of each route. ``pq`` times the p×q solves of ``chip_smoke.py``
3v on virtual ranks (f32, 8 right-hand sides: ``posv`` 16384/1024 on
2×2 and 2×4, ``gesv`` 16384/256 on 2×4, ``gesv_nopiv`` 16384/1024 on
2×2), each the median of three wall times after a warm-up, beside the
same call on Grid(1, 1), with the launches of one call, the peak device
memory above the inputs and ``info``; then ``posv`` 2×2 and ``gesv``
2×4 once under ``torch.profiler`` (``chip_smoke.phase_breakdown``).
``--only`` takes a comma-separated subset of k1k3, k2, k4, k5, k7, k10,
k11, k6, chase, chase_drift, lu_prof, pbsv_prof, posv, lu_gate, pq.
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
import inspect
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# what --only selects (all by default)
PARTS = ("k1k3", "k2", "k4", "k5", "k7", "k10", "k11", "k6", "chase",
         "chase_drift", "lu_prof", "pbsv_prof", "posv", "lu_gate", "pq")


def digest(ts) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)
                          ).hexdigest()[:16]


def dominant_tile(nb, gen):
    """G + nb·I: a tile the unpivoted LU factors without a small pivot."""
    import torch
    return (torch.randn(nb, nb, generator=gen, device="cuda")
            + nb * torch.eye(nb, device="cuda"))


def k5_rows(cs, K, gen, emit):
    """K5 at its callers' shapes: kernel and plain times (the plain
    version is one permute().contiguous(), the library call as well), the
    byte bound and a digest of the output; into a window of a wider
    matrix where the checkout's wrappers take ``out``."""
    import torch
    into = "out" in inspect.signature(K.panel_unfold).parameters
    N, NB, FN, FNB = cs.N, cs.NB, cs.FLAT_N, cs.FLAT_NB

    def row(label, name, fn, plain, x, ref_out=None):
        out = fn()
        ref = plain()
        torch.cuda.synchronize()
        same = torch.equal(out if ref_out is None else ref_out, ref)
        plain_ms = cs.time_ms(plain)
        emit(f"panel_transpose/{name}", label, dict(
            ms=cs.time_ms(fn), plain_ms=plain_ms, library_ms=plain_ms,
            bitwise=same, sha256=digest([ref]),
            bound=cs.bound(0, 2 * x.numel() * 4)))
        if not same:
            raise AssertionError(f"K5 {name} {label} differs from its plain "
                                 "version")

    fl = torch.randn(FN, FN, generator=gen, device="cuda")
    for w in (128, FNB):
        win = fl[:, :w]
        row(f"[{FN}, {w}] window -> [{w}, {FN}]", "transpose_tiled",
            lambda: K.panel_fold(win, 1, name="transpose_tiled")[0],
            lambda: K.panel_fold_plain(win, 1)[0], win)
        pT = K.panel_fold_plain(win, 1)
        row(f"[{w}, {FN}] -> [{FN}, {w}]", "transpose_tiled",
            lambda: K.panel_unfold(pT, name="transpose_tiled"),
            lambda: K.panel_unfold_plain(pT), pT)
        if into:
            dst = fl[:, FN - w:]
            row(f"[{w}, {FN}] -> [{FN}, {w}] window, in place",
                "transpose_tiled",
                lambda: K.panel_unfold(pT, name="transpose_tiled", out=dst),
                lambda: K.panel_unfold_plain(pT), pT, dst)
    x = torch.randn(FN, 128, generator=gen, device="cuda")
    row(f"[{FN}, 128]", "transpose_tiled",
        lambda: K.panel_fold(x, 1, name="transpose_tiled")[0],
        lambda: K.panel_fold_plain(x, 1)[0], x)
    del fl, x
    sub = torch.randn(N, 128, generator=gen, device="cuda")
    row(f"[{N}, 128]", "transpose_fold",
        lambda: K.panel_fold(sub, 8, name="transpose_fold"),
        lambda: K.panel_fold_plain(sub, 8), sub)
    sf = K.panel_fold_plain(sub, 8)
    row(f"[8, 128, {N // 8}]", "unfold_transpose",
        lambda: K.panel_unfold(sf, name="unfold_transpose"),
        lambda: K.panel_unfold_plain(sf), sf)
    a = torch.randn(N + 64, N, generator=gen, device="cuda")
    win = a[64:, :NB]
    row(f"[{N}, {NB}] window", "fold_panel",
        lambda: K.panel_fold(win, 8, name="fold_panel"),
        lambda: K.panel_fold_plain(win, 8), win)
    pcf = K.panel_fold_plain(win, 8)
    row(f"[8, {NB}, {N // 8}]", "unfold_panel",
        lambda: K.panel_unfold(pcf, name="unfold_panel"),
        lambda: K.panel_unfold_plain(pcf), pcf)
    if into:
        dst = a[64:, NB:2 * NB]
        row(f"[8, {NB}, {N // 8}] -> window, in place", "unfold_panel",
            lambda: K.panel_unfold(pcf, name="unfold_panel", out=dst),
            lambda: K.panel_unfold_plain(pcf), pcf, dst)


def chase_drift(cs, st, K, emit_line):
    """K8's and K9's reflectors against the f64 plain version on the card
    at the short chains of test_chase_kernels_match_plain (the test's
    band, seed n·band, and seven more seeds), beside the f32 plain
    version's own distance on the card and on the CPU; and each result's
    backward error: the band rebuilt in f64 from its d, e and reflectors
    against the band, relative Frobenius."""
    import numpy as np
    import torch
    from slate_tpu_torch.linalg.bulge import apply_bulge_reflectors
    bb = st.internal.band_bulge

    def rebuild_err(out, g, upper, b):
        n = g.shape[1]
        # the first min(b, n − 1) + 1 diagonals: those past the corner of
        # a band wider than the matrix are empty
        dense = cs.dense_band(g[:min(b, n - 1) + 1], upper)
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        o = [torch.as_tensor(x).double().cuda() for x in out[:6]]
        mid = torch.diag(o[0]) + torch.diag(o[1], 1)
        if upper:
            U2 = apply_bulge_reflectors(o[2], o[3], eye, b)
            V2 = apply_bulge_reflectors(o[4], o[5], eye, b)
            rebuilt = U2 @ mid @ V2.T
        else:
            Q = apply_bulge_reflectors(o[2], o[3], eye, b)
            rebuilt = Q @ (mid + torch.diag(o[1], -1)) @ Q.T
        return float(torch.linalg.norm(rebuilt - dense)
                     / torch.linalg.norm(dense))

    for n, b in ((12, 1), (50, 8), (40, 64)):
        for k in range(8):
            seed = n * b + 1000 * k
            ab = np.random.default_rng(seed).standard_normal(
                (b + 1, n)).astype(np.float32)
            g = torch.from_numpy(ab).cuda()
            for which, fn, plain, names in (
                    ("hb2st", K.hb2st_chase, bb.hb2st, ("V", "tau")),
                    ("tb2bd", K.tb2bd_chase, bb.tb2bd,
                     ("Vu", "tauu", "Vv", "tauv"))):
                out = [x.cpu().numpy() for x in fn(g)]
                ref = [x.cpu().numpy() for x in plain(g)]
                cpu = [x.numpy() for x in plain(torch.from_numpy(ab))]
                ref64 = [x.cpu().numpy() for x in plain(g.double())]
                row = dict(kernel=f"{which}_drift", n=n, band=b, seed=seed,
                           test_seed=k == 0)
                for nm, x, y, c, z in zip(names, out[2:6], ref[2:6],
                                          cpu[2:6], ref64[2:6]):
                    row[nm] = dict(kernel=float(np.abs(x - z).max()),
                                   plain_card=float(np.abs(y - z).max()),
                                   plain_cpu=float(np.abs(c - z).max()))
                upper = which == "tb2bd"
                row["backward"] = dict(
                    kernel=rebuild_err(out, g, upper, b),
                    plain_card=rebuild_err(ref, g, upper, b),
                    plain_f64=rebuild_err(ref64, g, upper, b))
                emit_line(row)


def lu_profile(cs, st, K, n, nb, seed, emit_line, out_dir):
    """One gesv under torch.profiler (device activity only): every device
    kernel by name with its launches and time; the K5 launches' mean; the
    copy and elementwise kernels' count."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = st.Matrix.from_dense(torch.randn(n, n, generator=gen, device="cuda"),
                             nb=nb, grid=grid)
    B = st.Matrix.from_dense(torch.randn(n, cs.NRHS, generator=gen,
                                         device="cuda"), nb=nb, grid=grid)
    st.gesv(A, B)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st.gesv(A, B)
        torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    names: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            r = names.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += e.time_range.elapsed_us()
    busy = sum(v[1] for v in names.values())
    cats: dict[str, list] = {}
    for nm, (c, us) in names.items():
        r = cats.setdefault(cs._category(nm), [0, 0.0])
        r[0] += c
        r[1] += us
    k5 = cats.get("panel transposes (K5)", [0, 0.0])
    cp = cats.get("copies and elementwise (layout, guards, padding, gathers)",
                  [0, 0.0])
    rows = sorted(names.items(), key=lambda kv: -kv[1][1])
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"gesv_{n}_{nb}_kernels.json").write_text(json.dumps(
            [dict(name=nm, category=cs._category(nm), launches=c, us=us)
             for nm, (c, us) in rows], indent=0))
    emit_line(dict(kernel="gesv_profile", n=n, nb=nb, busy_ms=busy / 1e3,
                   launch_counts=launches, k5_launches=k5[0],
                   k5_us_per_launch=k5[1] / k5[0] if k5[0] else None,
                   copy_kernels=cp[0], copy_ms=cp[1] / 1e3,
                   categories={c: dict(launches=v[0], ms=v[1] / 1e3)
                               for c, v in cats.items()}))


def lu_gate(cs, st, gen, emit_line):
    """gesv on the dense route and on the default route above 16384 (see
    the module docstring): each route's three wall times, their median,
    info and ‖A·X − B‖/(‖A‖·‖X‖)."""
    import os
    import torch
    grid = st.Grid(1, 1)
    for n in (20480, 24576, 32768):
        a = torch.randn(n, n, generator=gen, device="cuda")
        b = torch.randn(n, cs.NRHS, generator=gen, device="cuda")
        for nb in (512, 1024):
            A = st.Matrix.from_dense(a, nb=nb, grid=grid)
            B = st.Matrix.from_dense(b, nb=nb, grid=grid)
            ts = {"dense": [], "fast": []}
            res = {}

            def run(route, keep):
                os.environ["SLATE_LU_FAST"] = "0" if route == "dense" else ""
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                X, _, _, info = st.gesv(A, B)
                torch.cuda.synchronize()
                if keep:
                    ts[route].append((time.perf_counter() - t0) * 1e3)
                res[route] = (int(info), cs.solve_residual(
                    a, X.to_dense(), b))
                del X
            try:
                for route in ("dense", "fast"):
                    run(route, False)                         # warm-up
                for route in ("dense", "fast", "fast", "dense",
                              "dense", "fast"):
                    run(route, True)
            finally:
                os.environ.pop("SLATE_LU_FAST")
            emit_line(dict(kernel="gesv_gate", n=n, nb=nb, nrhs=cs.NRHS,
                           dense_ms=ts["dense"], fast_ms=ts["fast"],
                           dense_median_ms=sorted(ts["dense"])[1],
                           fast_median_ms=sorted(ts["fast"])[1],
                           info_dense=res["dense"][0],
                           info_fast=res["fast"][0],
                           residual_dense=res["dense"][1],
                           residual_fast=res["fast"][1]))
            del A, B
            torch.cuda.empty_cache()
        del a, b
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts: " + ", ".join(PARTS))
    ap.add_argument("--out", default=None,
                    help="directory for lu_prof's per-kernel JSON files")
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

    def emit_line(d):
        print(json.dumps(dict(**d, label=args.label, device=smi)),
              flush=True)

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

    if "k5" in want:
        k5_rows(cs, K, torch.Generator(device="cuda").manual_seed(5), emit)

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

    if "chase_drift" in want:
        chase_drift(cs, st, K, emit_line)

    if "lu_prof" in want:
        out_dir = (Path(args.out) / f"lu_prof_{args.label}" if args.out
                   else None)
        for n, nb, seed in ((cs.FLAT_N, cs.FLAT_NB, 5), (cs.N, cs.NB, 3)):
            lu_profile(cs, st, K, n, nb, seed, emit_line, out_dir)

    if "pbsv_prof" in want:
        grid = st.Grid(1, 1)
        s = cs.spd_band(cs.N, cs.PB_KD, 53)
        b = torch.randn(cs.N, cs.NRHS, generator=gen, device="cuda")
        A = st.HermitianBandMatrix.from_dense(s.tril(), nb=cs.AASEN_NB,
                                              grid=grid, kl=cs.PB_KD,
                                              ku=cs.PB_KD)
        B = st.Matrix.from_dense(b, nb=cs.AASEN_NB, grid=grid)
        st.pbsv(A, B)                                   # warm-up
        torch.cuda.synchronize()
        print(f"pbsv_prof {args.label} on {smi}: pbsv_ms "
              f"{cs.time_ms(lambda: st.pbsv(A, B), reps=7):.3f}", flush=True)
        cs.phase_breakdown("pbsv", lambda: st.pbsv(A, B), host_top=6)

    if "lu_gate" in want:
        lu_gate(cs, st, gen, emit_line)

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

    if "pq" in want:
        pq_times(cs, st, K, gen, emit_line)
    return 0


def pq_times(cs, st, K, gen, emit_line):
    """The ``pq`` part: the 3v solves' wall times, launches and memory."""
    import torch
    n = cs.N
    g = torch.randn(n, n, generator=gen, device="cuda")
    with cs._f32():
        a_spd = g @ g.T / n + torch.eye(n, device="cuda")
    del g
    a_gen = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, cs.NRHS, generator=gen, device="cuda")
    for kind, nb, grids in (("posv", cs.NB, ((2, 2), (2, 4))),
                            ("gesv", cs.PQ_LU_NB, ((2, 4),)),
                            ("gesv_nopiv", cs.NB, ((2, 2),))):
        a = a_spd if kind == "posv" else a_gen
        if kind == "gesv_nopiv":
            a = a_gen + n * torch.eye(n, device="cuda")
        for p, q in ((1, 1),) + grids:
            fn = cs.pq_call(kind, p, q, a, b, nb)
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
            out = fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            emit_line(dict(kernel=f"pq_{kind}", grid=[p, q], n=n, nb=nb,
                           ms=sorted(ts)[1], launches=launches,
                           peak_gib=peak, info=int(out[-1])))
            del out
        if kind == "posv":
            cs.phase_breakdown("posv Grid(2,2)",
                               cs.pq_call(kind, 2, 2, a, b, nb))
        elif kind == "gesv":
            cs.phase_breakdown("gesv Grid(2,4) nb=256",
                               cs.pq_call(kind, 2, 4, a, b, nb), cpu=False)
        del a


if __name__ == "__main__":
    sys.exit(main())
