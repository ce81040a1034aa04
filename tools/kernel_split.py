#!/usr/bin/env python3
"""Split the column step of the physical-swap panel LU (K10) and the block
step of the unpivoted tile LU (K7) of ``slate_tpu_torch`` into phases, on
one CUDA card.

    python3 tools/kernel_split.py [--root DIR] [--label NAME]

``ncu`` does not run where the card is, so the split is taken inside the
kernels: the script copies ``csrc/panel_plu_swap.cu`` and
``csrc/lu_nopiv_tile.cu`` of the checkout DIR (default: this one) into
``DIR/slate_tpu_torch/_build/split/``, adds ``clock64()`` counters at fixed
points of the copies (thread 0 of each CTA, or of each task, sums the
cycles of each phase into a device array), builds each copy with ``nvcc``
into a library of its own and runs it. The committed sources are never
changed. K10 runs at hesv's panel heights [16128, 256], [8192, 256],
[2048, 256] and [256, 256], in either of its two designs (a grid barrier
per column, or tagged candidate words with a deferred trailing update);
K7 (its dataflow design) at [1024, 1024]. Each output is checked against
the tree's plain version (K10 bit for bit). One JSON line a shape: the
instrumented kernel's time (CUDA events, median of 5), and per K10 column
or per K7 block step the time of each phase, its share of the counted
cycles applied to the measured time. The counters cost time of their
own, so compare phases within one line. The probe points are found by
text: a source they no longer match stops the script with the point's
name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]


def _mark(q: int, var: str = "q", tid: str = "tid") -> str:
    return (f"if ({tid} == 0) {{ long long c2 = clock64(); {var}[{q}] += "
            f"c2 - ck; ck = c2; }}")


# K10 with a grid barrier per column: (search and publish, grid barrier,
# reduction and winner row, exchange, multipliers, update)
SWAP_GRID = ("grid", [
    "search+publish", "grid_barrier", "reduce+winner_row", "exchange",
    "multipliers", "update"], [
    ("kernel arguments", "int R, int P) {",
     "int R, int P, long long* prof) {\n  long long q[8] = {};\n"
     "  long long ck = clock64();"),
    ("column start", "    const int slot = (j & 1) * G;",
     "    if (tid == 0) ck = clock64();\n    const int slot = (j & 1) * G;"),
    ("grid barrier", "    grid.sync();\n",
     "    __syncthreads();\n    " + _mark(0) + "\n    grid.sync();\n    "
     + _mark(1) + "\n"),
    ("winner row", """      if (k > j && !isfinite(u)) bad_u = 1;
    }
    __syncthreads();""", """      if (k > j && !isfinite(u)) bad_u = 1;
    }
    __syncthreads();
    """ + _mark(2)),
    ("exchange", """      if (g == 0) piv[j] = none ? h : wr;
    }
    __syncthreads();""", """      if (g == 0) piv[j] = none ? h : wr;
    }
    __syncthreads();
    """ + _mark(3)),
    ("multipliers", """      sx[j * P + i] = __fdiv_rn(sx[j * P + i], safe);
    __syncthreads();""", """      sx[j * P + i] = __fdiv_rn(sx[j * P + i], safe);
    __syncthreads();
    """ + _mark(4)),
    ("update", """      }
    }
    __syncthreads();
  }
""", """      }
    }
    __syncthreads();
    """ + _mark(5) + """
  }
  if (tid == 0) for (int u = 0; u < 8; ++u) prof[g * 8 + u] = q[u];
"""),
    ("entry arguments", "int max_ctas, int h, int w, void* stream) {",
     "int max_ctas, int h, int w, long long* prof, void* stream) {"),
    ("launch arguments", "&h, &w, &R, const_cast<int*>(&P)};",
     "&h, &w, &R, const_cast<int*>(&P), &prof};"),
])

# K10 with tagged candidate words and the trailing update deferred to the
# end of each 32-column block
SWAP_TAGGED = ("tagged", [
    "wait", "winner_row+exchange", "multipliers+column+search+publish",
    "rest_of_block_columns", "block_end_pivot_rows", "block_end_update",
    "block_end_nan_rules", "tail"], [
    ("kernel arguments", "int w, int R, int P) {\n",
     "int w, int R, int P, long long* prof) {\n  long long q[8] = {};\n"
     "  long long ck = clock64();\n"),
    ("wait", """      wait_winner(c, j, &s_win);
      __syncthreads();""", "      " + _mark(3) + """
      wait_winner(c, j, &s_win);
      __syncthreads();
      """ + _mark(0)),
    ("winner row", """        if (c.g == 0) piv[j] = none ? h : wr;
      }
      __syncthreads();""", """        if (c.g == 0) piv[j] = none ? h : wr;
      }
      __syncthreads();
      """ + _mark(1)),
    ("publish", "        publish(c, j + 1, kb, true, jb, jc);",
     "        publish(c, j + 1, kb, true, jb, jc);\n        " + _mark(2)),
    ("block end", """    }
    __syncthreads();

    // End of the block.""", """    }
    """ + _mark(3) + """
    __syncthreads();

    // End of the block."""),
    ("pivot rows", """      if (bad) s_bad = 1;
    }
    __syncthreads();""", """      if (bad) s_bad = 1;
    }
    __syncthreads();
    """ + _mark(4)),
    ("update", "    // The NaN rules of the block's steps.",
     "    " + _mark(5) + "\n    // The NaN rules of the block's steps."),
    ("NaN rules",
     "    if (je < kmax) publish(c, je, local_best(c, je), false, 0, 0);",
     "    " + _mark(6) + "\n    if (je < kmax) publish(c, je, "
     "local_best(c, je), false, 0, 0);"),
    ("kernel end", "  if (c.g == 0 && tid == 0) *info = zeros;",
     "  " + _mark(7) + "\n  if (tid == 0) for (int u = 0; u < 8; ++u) "
     "prof[c.g * 8 + u] = q[u];\n  if (c.g == 0 && tid == 0) *info = zeros;"),
    ("entry arguments", "int max_ctas, int h, int w, void* stream) {",
     "int max_ctas, int h, int w, long long* prof, void* stream) {"),
    ("launch arguments", "&h, &w, &R, const_cast<int*>(&P)};",
     "&h, &w, &R, const_cast<int*>(&P), &prof};"),
])

# K7's tasks: [0] start ns, [1] end ns, [2] the sum's products, [3] the
# diagonal factor (L/U: forming A - sum), [4] the diagonal's inverses
# (L/U: the wait for them), [5] the slot and publication (L/U: the
# product and publication), [6] the factor's warp panels, [7] the rest of
# the factor
LU_POINTS = [
    ("kernel arguments",
     "unsigned* flags, unsigned epoch) {",
     "unsigned* flags, unsigned epoch, long long* prof) {"),
    ("task start", """    const int r0 = i * BT, c0 = k * BT;
    const int hi""", """    long long* pr = prof + t * 8;
    long long ck = clock64();
    if (threadIdx.x == 0) pr[0] = (long long)now_ns();
    const int r0 = i * BT, c0 = k * BT;
    const int hi"""),
    ("sum", """    if (i == k) {
#pragma unroll""", "    " + _mark(2, "pr", "threadIdx.x") + """
    if (i == k) {
#pragma unroll"""),
    ("factor", "      lu_block(sd);\n",
     "      if (threadIdx.x == 0) { pr[6] = 0; pr[7] = 0; }\n"
     "      lu_block(sd, pr + 6);\n      "
     + _mark(3, "pr", "threadIdx.x") + "\n"),
    ("inverse", "      float* slot = inv + static_cast<size_t>(k) * 2 * BT * BT;",
     "      " + _mark(4, "pr", "threadIdx.x")
     + "\n      float* slot = inv + static_cast<size_t>(k) * 2 * BT * BT;"),
    ("wait", "      wait2(flags + task(m, m), nullptr, epoch);\n",
     "      " + _mark(3, "pr", "threadIdx.x")
     + "\n      wait2(flags + task(m, m), nullptr, epoch);\n      "
     + _mark(4, "pr", "threadIdx.x") + "\n"),
    ("task end", """    publish(flags + t, epoch);
  }""", """    publish(flags + t, epoch);
    if (threadIdx.x == 0) { pr[5] = clock64() - ck; pr[1] = (long long)now_ns(); }
  }"""),
    ("factor arguments", "__device__ void lu_block(float* s) {",
     "__device__ void lu_block(float* s, long long* pq) {\n"
     "  long long ck = clock64();"),
    ("panel", """    if (threadIdx.x < 32) lu_panel(s, p);
    __syncthreads();""", """    if (threadIdx.x < 32) lu_panel(s, p);
    __syncthreads();
    """ + _mark(0, "pq", "threadIdx.x")),
    ("trailing", """        if (i >= e && k >= e) s[i * PS + k] -= acc[r][cc];
      }
    __syncthreads();""", """        if (i >= e && k >= e) s[i * PS + k] -= acc[r][cc];
      }
    __syncthreads();
    """ + _mark(1, "pq", "threadIdx.x")),
    ("entry arguments",
     "unsigned epoch, void* stream) {",
     "unsigned epoch, long long* prof, void* stream) {"),
    ("launch arguments", "void* args[] = {&a, &nb, &inv, &flags, &epoch};",
     "void* args[] = {&a, &nb, &inv, &flags, &epoch, &prof};"),
]


def instrument(src: str, points, name: str) -> str:
    for label, old, new in points:
        if old not in src:
            raise SystemExit(f"kernel_split: {name}: probe point '{label}' "
                             "not found in the source")
        src = src.replace(old, new, 1)
    return src


def build(src: str, out: Path, name: str, csrc: Path) -> ctypes.CDLL:
    cu = out / f"{name}.cu"
    so = out / f"lib{name}.so"
    cu.write_text(src)
    from slate_tpu_torch.internal import _build
    subprocess.run([_build._nvcc(), *FLAGS, "-I", str(csrc), "-o", str(so),
                    str(cu)], check=True)
    return ctypes.CDLL(str(so))


def events_ms(fn, reps=5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def split_swap(root: Path, out: Path, label: str, smi: str) -> None:
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "panel_plu_swap.cu").read_text()
    design, names, points = SWAP_GRID if "grid.sync()" in src else SWAP_TAGGED
    lib = build(instrument(src, points, "panel_plu_swap"), out, "split_swap",
                csrc)
    fn = lib.slate_panel_plu_swap_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    nptr = 7 if design == "grid" else 6
    fn.argtypes = (P,) * nptr + (I,) * 3 + (P, P)
    fn.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(10)
    w = 256
    for h in (16128, 8192, 2048, 256):
        a = torch.randn(h, w, generator=gen, device="cuda")
        maxc = -(-h // 32) if design == "grid" else min(-(-h // 32), sms)
        piv = torch.empty(w, dtype=torch.int32, device="cuda")
        info = torch.empty(1, dtype=torch.int32, device="cuda")
        prof = torch.zeros(maxc * 8, dtype=torch.int64, device="cuda")

        def run():
            lu = a.clone()
            if design == "grid":
                bufs = [torch.empty(2 * maxc, device="cuda"),
                        torch.empty(2 * maxc, dtype=torch.int32,
                                    device="cuda"),
                        torch.empty(2 * maxc * w, device="cuda"),
                        torch.empty(2 * w, device="cuda")]
            else:
                cand = torch.zeros(2 * maxc * (w + 1) + 2 * w,
                                   dtype=torch.int64, device="cuda")
                bufs = [cand, cand[2 * maxc:2 * maxc * (w + 1)],
                        cand[2 * maxc * (w + 1):]]
            prof.zero_()
            rc = fn(*(P(t.data_ptr()) for t in (lu, piv, info, *bufs)),
                    maxc, h, w, P(prof.data_ptr()),
                    P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K10 launch error {rc}")
            return lu
        lu = run()
        ref, piv_p, _ = K.panel_plu_swap_plain(a)
        same = (torch.equal(lu.view(torch.int32), ref.view(torch.int32))
                and torch.equal(piv, piv_p))
        ms = events_ms(run)
        run()
        torch.cuda.synchronize()
        R = max(32, -(-h // sms))
        g = -(-h // R)
        p = prof.view(-1, 8)[:g, :len(names)].double().mean(0)
        us_col = ms * 1e3 / w
        print(json.dumps(dict(
            kernel="panel_plu_swap", design=design, shape=[h, w], ctas=g,
            bitwise_equal_to_plain=same, ms=ms, us_per_column=us_col,
            phases_us_per_column={n: float(v / p.sum()) * us_col
                                  for n, v in zip(names, p)},
            label=label, device=smi)), flush=True)


def split_lu(root: Path, out: Path, label: str, smi: str) -> None:
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "lu_nopiv_tile.cu").read_text()
    if "dataflow.cuh" not in src:
        print(json.dumps(dict(kernel="lu_nopiv_tile", design="host loop",
                              split=None, label=label, device=smi)))
        return
    lib = build(instrument(src, LU_POINTS, "lu_nopiv_tile"), out, "split_lu",
                csrc)
    fn = lib.slate_lu_nopiv_tile_f32
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = (P, I, P, P, U, P, P)
    fn.restype = I
    nb, bt = 1024, 64
    nt = nb // bt
    gen = torch.Generator(device="cuda").manual_seed(7)
    a = (torch.randn(nb, nb, generator=gen, device="cuda")
         + nb * torch.eye(nb, device="cuda"))
    inv = torch.empty(nt * 2 * bt * bt, device="cuda")
    flags = torch.zeros(nt * nt, dtype=torch.int32, device="cuda")
    prof = torch.zeros(nt * nt * 8, dtype=torch.int64, device="cuda")
    epoch = [0]

    def run():
        lu = a.clone()
        prof.zero_()
        epoch[0] += 1
        rc = fn(P(lu.data_ptr()), nb, P(inv.data_ptr()), P(flags.data_ptr()),
                epoch[0], P(prof.data_ptr()),
                P(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise SystemExit(f"kernel_split: K7 launch error {rc}")
        return lu
    lu = run()
    ref, _ = K.lu_nopiv_tile_plain(a)
    err = float(torch.linalg.norm(lu.double() - ref.double())
                / torch.linalg.norm(ref.double()))
    ms = events_ms(run)
    run()
    torch.cuda.synchronize()
    pr = prof.view(-1, 8).double().cpu()

    def task(i, k):
        s, d = min(i, k), abs(i - k)
        return s * (2 * nt - s) + (0 if d == 0 else 2 * d - (i > k))
    diag = pr[[task(s, s) for s in range(nt)]]
    lt = pr[[task(s + 1, s) for s in range(nt - 1)]]
    # cycles per ns of the SM clock, from the diagonal tasks' own spans
    ghz = float(diag[:, 2:6].sum() / (diag[:, 1] - diag[:, 0]).sum())
    step_us = float((diag[-1, 1] - diag[0, 1]) / (nt - 1) / 1e3)

    def us(col, rows):
        return float(rows[:, col].mean() / ghz / 1e3)
    print(json.dumps(dict(
        kernel="lu_nopiv_tile", design="dataflow", shape=[nb, nb], ms=ms,
        rel_err_to_plain=err, sm_clock_ghz=ghz, step_us=step_us,
        diagonal_task_us=dict(factor_panels=us(6, diag),
                              factor_rest=us(7, diag),
                              inverses=us(4, diag),
                              slot_and_publish=us(5, diag)),
        l_task_us=dict(product_and_publish=us(5, lt)),
        label=label, device=smi)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    out = root / "slate_tpu_torch/_build/split"
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    split_swap(root, out, args.label, smi)
    split_lu(root, out, args.label, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
