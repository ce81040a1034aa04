#!/usr/bin/env python3
"""Split the column step of the by-index panel LU (K4) and of the
physical-swap panel LU (K10), and the block step of the unpivoted tile LU
(K7) of ``slate_tpu_torch`` into phases, and time the right triangular
solve (K2) against variants of its design, on one CUDA card.

    python3 tools/kernel_split.py [--root DIR] [--label NAME]

``ncu`` does not run where the card is, so the split is taken inside the
kernels: the script copies ``csrc/panel_plu.cu``, ``csrc/panel_plu_swap.cu``,
``csrc/lu_nopiv_tile.cu`` and ``csrc/trsm_lower.cu`` of the checkout DIR
(default: this one) into ``DIR/slate_tpu_torch/_build/split/``, adds
``clock64()`` counters at fixed points of the copies (thread 0 of each
CTA, or of each task, sums the cycles of each phase into a device array)
or K2's variants, builds each copy with ``nvcc`` into a library of its
own and runs it. The committed sources are never changed. K4 runs at its
callers' shapes ([8, 1024, 2048] block 0, [8, 128, 2048], [1, 128,
7424]) and K10 at hesv's panel heights [16128, 256], [8192, 256],
[2048, 256] and [256, 256], each in either of its designs (a grid
barrier per column, or tagged candidate words with a deferred trailing
update); K7 (its dataflow design) at [1024, 1024]. K2's variants (its
inverse formed at each tile task's start into a third shared buffer, the
inverse tasks skipped; 64-row blocks at every m; 128-row blocks at every
m) run beside the committed K2 at the posv panel heights B [1024·k,
1024], k = 1 … 15, each with its relative error to the plain version.
Each output is checked against the tree's plain version (K4 and K10 bit
for bit). One JSON line a shape: the instrumented kernel's time (CUDA
events, median of 5), and per K4 or K10 column or per K7 block step the
time of each phase, its share of the counted cycles applied to the
measured time. The counters cost time of their
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

# K4 with a grid barrier per column: (search and publish, grid barrier,
# reduction and winner row, multipliers, update)
PLU_GRID = ("grid", [
    "search+publish", "grid_barrier", "reduce+winner_row", "multipliers",
    "update"], [
    ("kernel arguments", "int L, int blk, int R, int h) {",
     "int L, int blk, int R, int h, long long* prof) {\n  long long q[8] = {};"
     "\n  long long ck = clock64();"),
    ("column start", "    const int slot = (j & 1) * G;",
     "    if (tid == 0) ck = clock64();\n    const int slot = (j & 1) * G;"),
    ("grid barrier", "    grid.sync();\n",
     "    __syncthreads();\n    " + _mark(0) + "\n    grid.sync();\n    "
     + _mark(1) + "\n"),
    ("winner row", """      if (!none && wr >= r0 && wr < r0 + nr) sact[wr - r0] = 0.f;
    }
    __syncthreads();""", """      if (!none && wr >= r0 && wr < r0 + nr) sact[wr - r0] = 0.f;
    }
    __syncthreads();
    """ + _mark(2)),
    ("multipliers", """      if (sact[i] > 0.f) sx[j * R + i] = __fmul_rn(sx[j * R + i], rsafe);
    __syncthreads();""", """      if (sact[i] > 0.f) sx[j * R + i] = __fmul_rn(sx[j * R + i], rsafe);
    __syncthreads();
    """ + _mark(3)),
    ("update", """        sx[k * R + i] = __fsub_rn(sx[k * R + i], __fmul_rn(su[k], sx[j * R + i]));
    }
    __syncthreads();
  }
""", """        sx[k * R + i] = __fsub_rn(sx[k * R + i], __fmul_rn(su[k], sx[j * R + i]));
    }
    __syncthreads();
    """ + _mark(4) + """
  }
  if (tid == 0) for (int u = 0; u < 8; ++u) prof[g * 8 + u] = q[u];
"""),
    ("entry arguments", """int max_ctas, int S, int nb, int L, int blk,
                                   void* stream) {""", """int max_ctas, int S, int nb, int L, int blk,
                                   long long* prof, void* stream) {"""),
    ("launch arguments", "&nb, &L, &blk, &R, const_cast<int*>(&h)};",
     "&nb, &L, &blk, &R, const_cast<int*>(&h), &prof};"),
])

# K4 with tagged candidate words and the trailing update deferred to the
# end of each 32-column block
PLU_TAGGED = ("tagged", [
    "wait", "winner_row", "multipliers+column+search+publish",
    "rest_of_block_columns", "block_end_pivot_rows", "block_end_update",
    "block_end_publish", "tail"], [
    ("kernel arguments", "int R, int P, int h, unsigned epoch) {\n",
     "int R, int P, int h, unsigned epoch, long long* prof) {\n"
     "  long long q[8] = {};\n  long long ck = clock64();\n"),
    ("wait", """      wait_winner(c, j, &s_win);
      __syncthreads();""", "      " + _mark(3) + """
      wait_winner(c, j, &s_win);
      __syncthreads();
      """ + _mark(0)),
    ("winner row", """          sact[wr - r0] = 0.f;
        }
      }
      __syncthreads();""", """          sact[wr - r0] = 0.f;
        }
      }
      __syncthreads();
      """ + _mark(1)),
    ("publish", "        publish(c, j + 1, kb, true, jb);",
     "        publish(c, j + 1, kb, true, jb);\n        " + _mark(2)),
    ("block end", "    __syncthreads();\n    if (jc == W) break;",
     "    " + _mark(3) + "\n    __syncthreads();\n    if (jc == W) break;"),
    ("pivot rows", """      for (int t = 0; t < IB; ++t) ub[t * W + k] = x[t];
    }
    __syncthreads();""", """      for (int t = 0; t < IB; ++t) ub[t * W + k] = x[t];
    }
    __syncthreads();
    """ + _mark(4)),
    ("update", "    publish(c, jc, local_best(c, jc), false, 0);",
     "    " + _mark(5) + "\n    publish(c, jc, local_best(c, jc), false, 0);"
     "\n    " + _mark(6)),
    ("kernel end", "  if (c.g == 0 && tid == 0) *info = zeros;",
     "  " + _mark(7) + "\n  if (tid == 0) for (int u = 0; u < 8; ++u) "
     "prof[c.g * 8 + u] = q[u];\n  if (c.g == 0 && tid == 0) *info = zeros;"),
    ("entry arguments", "int nb, int L, int blk, void* stream) {",
     "int nb, int L, int blk, long long* prof, void* stream) {"),
    ("launch arguments", "const_cast<int*>(&h), &ep};",
     "const_cast<int*>(&h), &ep, &prof};"),
])

PLU_SHAPES = ((8, 1024, 2048, "plu_call_folded_block"),
              (8, 128, 2048, "plu_call_folded"),
              (1, 128, 7424, "plu_call"))


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


def split_plu(root: Path, out: Path, label: str, smi: str) -> None:
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "panel_plu.cu").read_text()
    if "grid.sync()" in src:
        design, names, points = PLU_GRID
    else:
        design, names, points = PLU_TAGGED
    lib = build(instrument(src, points, "panel_plu"), out, "split_plu", csrc)
    fn = lib.slate_plu_block_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(4)
    for S, nb, L, name in PLU_SHAPES:
        h = S * L
        buf = torch.randn(S, nb, L, generator=gen, device="cuda")
        act = (torch.rand(h, generator=gen, device="cuda") >= 0.18).float()
        R = max(32, -(-h // sms))
        g = -(-h // R)
        piv = torch.empty(128, dtype=torch.int32, device="cuda")
        info = torch.empty(1, dtype=torch.int32, device="cuda")
        prof = torch.zeros(g * 8, dtype=torch.int64, device="cuda")
        if design == "grid":
            fn.argtypes = (P,) * 7 + (I,) * 5 + (P, P)
            bufs = [torch.empty(2 * g, device="cuda"),
                    torch.empty(2 * g, dtype=torch.int32, device="cuda"),
                    torch.empty(2 * g * 128, device="cuda")]
            extra = (g,)
        else:
            fn.argtypes = (P,) * 5 + (I,) * 6 + (P, P)
            bufs = [torch.zeros(2 * sms * 129, dtype=torch.int64,
                                device="cuda")]
            extra = (sms, 0)
        epoch = [0]

        def run():
            b, a = buf.clone(), act.clone()
            prof.zero_()
            if design != "grid":
                epoch[0] = epoch[0] % 255 + 1
                if epoch[0] == 1:
                    bufs[0].zero_()
            ex = extra if design == "grid" else (sms, epoch[0])
            rc = fn(*(P(t.data_ptr()) for t in (b, a, piv, info, *bufs)),
                    *ex, S, nb, L, 0, P(prof.data_ptr()),
                    P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K4 launch error {rc}")
            return b, a
        kb, ka = run()
        pb, pa = buf.clone(), act.clone()
        piv_p, info_p = K.panel_plu_plain(pb, pa, 0)
        same = (torch.equal(kb.view(torch.int32), pb.view(torch.int32))
                and torch.equal(ka, pa) and torch.equal(piv, piv_p)
                and int(info) == int(info_p))
        ms = events_ms(run)
        run()
        torch.cuda.synchronize()
        p = prof.view(-1, 8)[:g, :len(names)].double().mean(0)
        us_col = ms * 1e3 / 128
        print(json.dumps(dict(
            kernel=f"panel_plu/{name}", design=design, shape=[S, nb, L],
            ctas=g, bitwise_equal_to_plain=same, ms=ms,
            us_per_column=us_col,
            phases_us_per_column={n: float(v / p.sum()) * us_col
                                  for n, v in zip(names, p)},
            label=label, device=smi)), flush=True)


# K2 with inv(L[c, c]) recomputed at the start of every tile task
K2_PER_TASK = [
    ("inverse tasks", "    if (t < NC) {\n", "    if (t < NC) {\n      continue;\n"),
    ("task start", """    const float* lr = l + static_cast<size_t>(c0) * n;
""", """    const float* lr = l + static_cast<size_t>(c0) * n;
    float* sd = sm + (2 * BM + 2 * BT) * PL;
    load_cg(sa(0), PL, l + static_cast<size_t>(c0) * n + c0, n, wc, wc);
    __syncthreads();
    inv_lower(sa(0), PL, sd, PL, sb(0), wc, unit != 0);
"""),
    ("inverse read", """    wait2(dflag + c, nullptr, epoch);
    load_tile<BT, VEC>(sb(0), dinv + static_cast<size_t>(c) * BT * BT, BT, BT, BT);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float out[RM][4] = {};
    prod<RM, 1>(sa(0), sb(0), out);""", """    __syncthreads();
    float out[RM][4] = {};
    prod<RM, 1>(sa(0), sd, out);"""),
    ("shared memory", "const size_t smem = (2 * BM + 2 * BT) * PL * sizeof(float);",
     "const size_t smem = (2 * BM + 3 * BT) * PL * sizeof(float);"),
]
# K2 with one row block at every m (the committed K2 switches at 4096)
K2_ROWS = {rows: [("row-block switch", "constexpr int NARROW_MAX = 4096;",
                   f"constexpr int NARROW_MAX = {limit};")]
           for rows, limit in ((64, "1 << 30"), (128, "0"))}


def time_k2_variants(root: Path, out: Path, label: str, smi: str) -> None:
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "trsm_lower.cu").read_text()
    if "dinv" not in src:
        print(json.dumps(dict(kernel="trsm_right_lower_t", design="rows",
                              variants=None, label=label, device=smi)))
        return
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fns = {}
    for name, points in (("inverses_per_task", K2_PER_TASK),
                         ("rows64", K2_ROWS[64]), ("rows128", K2_ROWS[128])):
        fn = build(instrument(src, points, "trsm_lower"), out, f"k2_{name}",
                   csrc).slate_trsm_right_lower_t_f32
        fn.argtypes = (P, P, P, I, I, I, P, U, P)
        fn.restype = I
        fns[name] = fn
    n = 1024
    gen = torch.Generator(device="cuda").manual_seed(2)
    l = (torch.tril(torch.randn(n, n, generator=gen, device="cuda")) / n
         + torch.eye(n, device="cuda"))
    dinv = torch.empty(16 * 64 * 64, device="cuda")
    for k in range(1, 16):
        m = k * n
        b = torch.randn(m, n, generator=gen, device="cuda")
        ref = K.trsm_right_lower_t_plain(l, b)
        row = dict(kernel="trsm_right_lower_t", shape=[m, n],
                   committed_ms=events_ms(lambda: K.trsm_right_lower_t(l, b)))
        for name, fn in fns.items():
            def run():
                x = b.clone()
                flags, epoch = K._ready_flags(b.device,
                                              16 * (1 + -(-m // 64)))
                rc = fn(P(l.data_ptr()), P(x.data_ptr()), P(dinv.data_ptr()),
                        m, n, 0, P(flags.data_ptr()), epoch,
                        P(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise SystemExit(f"kernel_split: K2 launch error {rc}")
                return x
            x = run()
            row[f"{name}_rel_err"] = float(torch.linalg.norm(x - ref)
                                           / torch.linalg.norm(ref))
            row[f"{name}_ms"] = events_ms(run)
        print(json.dumps(dict(**row, label=label, device=smi)), flush=True)


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
    split_plu(root, out, args.label, smi)
    time_k2_variants(root, out, args.label, smi)
    split_swap(root, out, args.label, smi)
    split_lu(root, out, args.label, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
