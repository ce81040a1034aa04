#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``slate_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Device and toolchain: the card's name and power limit, torch and
   CUDA versions, ``nvcc --version``; builds the kernels of
   ``slate_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   prints the build time and ``ptxas`` report.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and at small ragged shapes: relative error
   against the stated tolerance, then, at the main-path shape, the
   kernel's time, the plain version's time, the ``torch.linalg`` call's
   time (CUDA events, median of 7 runs after a warm-up) and the least
   time the card could take (FP32 operations or bytes).
3. The main path: ``posv`` at f32, n=16384, nb=1024 on ``Grid(1, 1)``
   with A = G·Gᵀ/n + I (built with the port's ``gemm``) and 8
   right-hand sides; checks ``info == 0``, the residual bound, and that
   each kernel was launched on this path; prints ``potrf``/``posv``
   times, the peak memory of ``posv``, and where one ``posv``'s device
   time goes under ``torch.profiler``.
4. Failure report: a non-SPD matrix whose leading 256×256 block is not
   positive definite gives ``info == 2`` on the card and on the CPU;
   a small SPD solve agrees between the two.

Any failure raises and the script exits non-zero. Without a CUDA card
it exits with code 2 before doing anything. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N, NB, NRHS = 16384, 1024, 8
TOL = 1e-5                # kernel vs plain: relative Frobenius error, FP32
FP32_PEAK = 67e12         # H100 SXM, non-tensor FP32 FLOP/s (data sheet)
HBM_RATE = 3.35e12        # H100 SXM, bytes/s (data sheet)
REPS = 7

KERNELS = {
    "potrf_tile": ("slate_tpu_torch/csrc/potrf_tile.cu",
                   "slate_tpu/internal/pallas_kernels.py:428"),
    "trsm_right_lower_t": ("slate_tpu_torch/csrc/trsm_lower.cu",
                           "slate_tpu/internal/pallas_kernels.py:613"),
    "trsm_left_lower": ("slate_tpu_torch/csrc/trsm_lower.cu",
                        "slate_tpu/internal/pallas_kernels.py:594"),
}


def say(*a):
    print(*a, flush=True)


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(x, ref) -> float:
    return float(torch.linalg.norm(x.double() - ref.double())
                 / torch.linalg.norm(ref.double()))


def spd_tile(n, gen):
    g = torch.randn(n, n, generator=gen, device="cuda")
    with _f32():
        return g @ g.T / n + torch.eye(n, device="cuda")


def _f32():
    from slate_tpu_torch.internal.precision import full_f32_matmul
    return full_f32_matmul()


def lower_factor(n, gen, unit=False):
    """Random lower-triangular with bounded condition number."""
    l = torch.tril(torch.randn(n, n, generator=gen, device="cuda")) / n
    l += torch.eye(n, device="cuda")
    if unit:
        l.fill_diagonal_(1.0)
    return l


def phase_toolchain():
    from slate_tpu_torch.internal import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"device: {smi}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say(f"toolchain: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc[-1]}")
    t0 = time.perf_counter()
    _build.build()
    say(f"build_s: {time.perf_counter() - t0:.3f}")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas[{name}]: {line.strip()}")
    # the FP32 pin restores the caller's TF32 choice
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    with _f32():
        assert not torch.backends.cuda.matmul.allow_tf32, "TF32 not pinned off"
    assert torch.backends.cuda.matmul.allow_tf32, "TF32 setting not restored"
    torch.backends.cuda.matmul.allow_tf32 = prev
    return smi


def check(name, kernel_fn, plain_fn, label):
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    err = rel_err(out, ref)
    mx = float((out - ref).abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= TOL
    say(f"  {name} {label}: rel_err {err:.3e} (tol {TOL:g}), "
        f"max_abs_err {mx:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return mx


def phase_kernels():
    from slate_tpu_torch.internal import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    say("kernel checks (kernel vs plain on the card):")
    for nb in (NB, 200):
        a = spd_tile(nb, gen)
        mx = check("potrf_tile", lambda: K.potrf_tile(a),
                   lambda: K.potrf_tile_plain(a), f"nb={nb}")
        assert float(torch.triu(K.potrf_tile(a), 1).abs().max()) == 0.0
        if nb == NB:
            rows["potrf_tile"] = dict(
                max_abs_err=mx,
                ms=time_ms(lambda: K.potrf_tile(a)),
                plain_ms=time_ms(lambda: K.potrf_tile_plain(a)),
                library_ms=time_ms(lambda: torch.linalg.cholesky(a)),
                bound=bound(nb ** 3 / 3, 2 * nb * nb * 4))

    for (m, n) in ((N - NB, NB), (300, 200)):
        for unit in (False, True):
            l = lower_factor(n, gen, unit)
            b = torch.randn(m, n, generator=gen, device="cuda")
            mx = check("trsm_right_lower_t",
                       lambda: K.trsm_right_lower_t(l, b, unit),
                       lambda: K.trsm_right_lower_t_plain(l, b, unit),
                       f"B=[{m},{n}] unit={unit}")
            if (m, n) == (N - NB, NB) and not unit:
                rows["trsm_right_lower_t"] = dict(
                    max_abs_err=mx,
                    ms=time_ms(lambda: K.trsm_right_lower_t(l, b)),
                    plain_ms=time_ms(lambda: K.trsm_right_lower_t_plain(l, b)),
                    library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                        l.mT, b, upper=True, left=False)),
                    bound=bound(m * n * n, (n * n + 2 * m * n) * 4))

    for (n, m) in ((NB, NB), (200, 37)):
        for unit in (False, True):
            l = lower_factor(n, gen, unit)
            b = torch.randn(n, m, generator=gen, device="cuda")
            mx = check("trsm_left_lower",
                       lambda: K.trsm_left_lower(l, b, unit),
                       lambda: K.trsm_left_lower_plain(l, b, unit),
                       f"B=[{n},{m}] unit={unit}")
            if (n, m) == (NB, NB) and not unit:
                rows["trsm_left_lower"] = dict(
                    max_abs_err=mx,
                    ms=time_ms(lambda: K.trsm_left_lower(l, b)),
                    plain_ms=time_ms(lambda: K.trsm_left_lower_plain(l, b)),
                    library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                        l, b, upper=False)),
                    bound=bound(n * n * m, (n * n + 2 * n * m) * 4))
    for name, r in rows.items():
        say(f"  {name}: kernel_ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f}, "
            f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")
    return rows


def phase_main_path():
    import slate_tpu_torch as st
    from slate_tpu_torch.internal import kernels as K
    grid = st.Grid(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    G = st.Matrix.from_dense(
        torch.randn(N, N, generator=gen, device="cuda"), nb=NB, grid=grid)
    I = st.Matrix.from_dense(torch.eye(N, device="cuda"), nb=NB, grid=grid)
    C = st.gemm(1.0 / N, G, st.transpose(G), 1.0, I)
    del G, I
    A = st.HermitianMatrix(data=C.data, m=N, n=N, nb=NB, grid=grid)
    del C
    B = st.Matrix.from_dense(
        torch.randn(N, NRHS, generator=gen, device="cuda"), nb=NB, grid=grid)

    st.potrf(A)                         # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    t0 = time.perf_counter()
    X, L, info = st.posv(A, B)
    torch.cuda.synchronize()
    posv_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    t0 = time.perf_counter()
    st.potrf(A)
    torch.cuda.synchronize()
    potrf_ms = (time.perf_counter() - t0) * 1e3

    info = int(info)
    x = X.to_dense()
    a = A.to_dense()
    b = B.to_dense()
    with _f32():
        r = float(torch.linalg.norm(a @ x - b)
                  / (torch.linalg.norm(a) * torch.linalg.norm(x)))
    limit = 10 * N * 2.0 ** -24
    say(f"main path: posv f32 n={N} nb={NB} nrhs={NRHS} Grid(1,1): "
        f"info {info}, residual {r:.3e} (bound {limit:.3e})")
    say(f"  potrf_ms {potrf_ms:.3f} ({N ** 3 / 3 / potrf_ms / 1e6:.1f} "
        f"GFLOP/s at n^3/3), posv_ms {posv_ms:.3f}, posv peak device "
        f"memory above its inputs {peak_gib:.3f} GiB")
    say(f"  kernels: {json.dumps(launches)}")
    assert info == 0, f"posv info {info}"
    assert tuple(x.shape) == (N, NRHS) and bool(torch.isfinite(x).all())
    assert r <= limit, f"residual {r} above {limit}"
    nt = N // NB
    expect = {"potrf_tile": nt, "trsm_right_lower_t": nt - 1,
              "trsm_left_lower": nt}
    assert launches == expect, f"launches {launches}, expected {expect}"
    phase_breakdown(st, A, B)
    return launches


def _category(name: str) -> str:
    if any(k in name for k in ("chol_diag", "panel", "trailing")):
        return "potrf_tile kernel"
    if "trsm_lower" in name:
        return "trsm kernels (ours)"
    if "gemm" in name or "xmma" in name or "cutlass" in name:
        return "cuBLAS gemm (trailing update, trsm update)"
    if "trsm" in name:
        return "cuBLAS trsm (potrs back solve)"
    return "copies and elementwise (layout, guards, padding)"


def phase_breakdown(st, A, B):
    """Where the device time of one posv goes: kernel time by category
    from torch.profiler, and the device's busy share of the wall time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.posv(A, B)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cats: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = _category(e.name)
            cats[c] = cats.get(c, 0.0) + e.time_range.elapsed_us()
    busy = sum(cats.values())
    if not busy:
        say("breakdown: the profiler saw no device time: not measured")
        return
    say(f"breakdown of one posv under torch.profiler: wall_ms "
        f"{wall_us / 1e3:.3f}, device busy_ms {busy / 1e3:.3f} "
        f"(busy share {busy / wall_us:.3f})")
    for c, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        say(f"  {c}: {us / 1e3:.3f} ms ({us / busy:.3f} of device time)")


def phase_failure_report():
    import slate_tpu_torch as st
    n, nb = 300, 128
    rng = np.random.default_rng(7)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    xs = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        X, _, info = st.posv(st.HermitianMatrix.from_dense(a, nb=nb, grid=grid),
                             st.Matrix.from_dense(b, nb=nb, grid=grid))
        assert int(info) == 0
        xs[dev] = X.to_dense().cpu()
    err = rel_err(xs["cuda"], xs["cpu"])
    say(f"small posv n={n} nb={nb}: card vs CPU rel_err {err:.3e} (tol 1e-4)")
    assert err <= 1e-4
    bad = a.copy()
    bad[200, 200] = -100.0    # leading 128 block SPD, leading 256 block not
    infos = {}
    for dev in ("cuda", "cpu"):
        grid = st.Grid(1, 1, device=dev)
        _, info = st.potrf(st.HermitianMatrix.from_dense(bad, nb=nb, grid=grid))
        infos[dev] = int(info)
    say(f"failure report: info card {infos['cuda']}, CPU {infos['cpu']}")
    assert infos == {"cuda": 2, "cpu": 2}, infos


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import slate_tpu_torch  # noqa: F401 — fails outside a checkout
    smi = phase_toolchain()
    rows = phase_kernels()
    launches = phase_main_path()
    phase_failure_report()
    out = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": out}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
