#!/usr/bin/env python3
"""Split the column step of the by-index panel LU (K4) and of the
physical-swap panel LU (K10), the block step of the unpivoted tile LU
(K7) and the task of the band → tridiagonal chase (K8) of
``slate_tpu_torch`` into phases, and time the right triangular solve
(K2) against variants of its design, on one CUDA card.

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
update); K7 (its dataflow design) at [1024, 1024]; K8, in its design of
one launch per wave (``hb2st_wave`` in ``csrc/band_chase.cu``), at
(n, band) = (8192, 128) and (4096, 128): each task's phases (B load
with the previous reflector, its right-apply, ``larfg``, the left-apply,
B's store and mirror, D's load, the two-sided D update, D's and V/τ's
store; a barrier closes each phase, so the stores count the time to
start them only) for the tasks of the middle sweep and for the t = 0 tasks, the
instrumented copy's outputs held bit for bit to the committed kernel's,
and the gap between waves: the waves' span minus the sum of their
longest tasks (device clock), beside a copy whose tasks return at once
(the launches alone, same grids); K8 in its design of one cooperative
launch (``csrc/hb2st_chase.cu`` on ``csrc/chase_flow.cuh``, whose copy
goes beside the other) at the same shapes: each task's three waits, its
early loads and right-apply, the rest of stage 1, its publishes and its
D stage, the time from a done[] publish to the part that waits for it,
and the lag between a sweep and the next. K2's variants (its
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


# K8's task in its one-launch-per-wave design: thread 0 sums each phase's
# cycles, and takes the task's start and end on the global clock
_K8_MARK = {q: _mark(q) for q in range(8)}
K8_PHASES = ["B_load", "right_apply", "larfg", "left_apply",
             "B_store_mirror", "D_load", "D_update", "D_V_tau_store"]
K8_POINTS = [
    ("kernel", "__global__ void __launch_bounds__(NTH)\nhb2st_wave(",
     """__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(NTH)
hb2st_wave("""),
    ("kernel arguments", """float* __restrict__ tau, float* scratch) {
  extern __shared__ float dyn[];
  __shared__ Vectors sh;
  int s, t, i0;
  if (!task_of(w, s_lo, n, b, T, s, t, i0)) return;""",
     """float* __restrict__ tau, float* scratch, long long* prof) {
  extern __shared__ float dyn[];
  __shared__ Vectors sh;
  int s, t, i0;
  if (!task_of(w, s_lo, n, b, T, s, t, i0)) return;
  long long q[8] = {};
  const unsigned long long ns0 = gtime();
  long long ck = clock64();"""),
    ("seed load", """    for (int i = tid; i < L; i += NTH) v[i] = R.at(i0 + i, s);
    __syncthreads();
    larfg(v, L, sh.sc);""", """    for (int i = tid; i < L; i += NTH) v[i] = R.at(i0 + i, s);
    __syncthreads();
    """ + _K8_MARK[0] + """
    larfg(v, L, sh.sc);
    """ + _K8_MARK[2]),
    ("seed store", """      R.at(s, i0 + i) = x;
    }
  } else {""", """      R.at(s, i0 + i) = x;
    }
    __syncthreads();
    """ + _K8_MARK[4] + """
  } else {"""),
    ("B load", """    const float tp = tau[task - 1];
    __syncthreads();""", """    const float tp = tau[task - 1];
    __syncthreads();
    """ + _K8_MARK[0]),
    ("right-apply", """      B[i * ld + k] -= (tp * sh.w[i]) * vp[k];
    }
    __syncthreads();""", """      B[i * ld + k] -= (tp * sh.w[i]) * vp[k];
    }
    __syncthreads();
    """ + _K8_MARK[1]),
    ("larfg", """    larfg(v, L, sh.sc);
    const float beta = sh.sc[0], tv = sh.sc[1];
    // annihilate the bulge column""", """    larfg(v, L, sh.sc);
    """ + _K8_MARK[2] + """
    const float beta = sh.sc[0], tv = sh.sc[1];
    // annihilate the bulge column"""),
    ("left-apply", """      else B[i * ld + k] -= (tv * v[i]) * sh.w[k - 1];
    }
    __syncthreads();""", """      else B[i * ld + k] -= (tv * v[i]) * sh.w[k - 1];
    }
    __syncthreads();
    """ + _K8_MARK[3]),
    ("B store", """    store_mirror(B, ld, R, i0, L, j0, b);
  }""", """    store_mirror(B, ld, R, i0, L, j0, b);
    __syncthreads();
    """ + _K8_MARK[4] + """
  }"""),
    ("D load", """  load(D, ld, R, i0, L, i0, L);
  __syncthreads();""", """  load(D, ld, R, i0, L, i0, L);
  __syncthreads();
  """ + _K8_MARK[5]),
    ("D update", """    D[i * ld + k] -= (tv * sh.w[i]) * v[k];
  }
  __syncthreads();
  store(D, ld, R, i0, L, i0, L);""", """    D[i * ld + k] -= (tv * sh.w[i]) * v[k];
  }
  __syncthreads();
  """ + _K8_MARK[6] + """
  store(D, ld, R, i0, L, i0, L);"""),
    ("task end", """  if (tid == 0) tau[task] = tv;
}""", """  if (tid == 0) tau[task] = tv;
  __syncthreads();
  """ + _K8_MARK[7] + """
  if (tid == 0) {
    long long* p = prof + task * 10;
    for (int u = 0; u < 8; ++u) p[u] = q[u];
    p[8] = static_cast<long long>(ns0);
    p[9] = static_cast<long long>(gtime());
  }
}"""),
    ("launch", "hb2st_wave<<<cnt, NTH, smem, st>>>(R, n, b, T, w, s_lo, V, tau, scratch);",
     "hb2st_wave<<<cnt, NTH, smem, st>>>(R, n, b, T, w, s_lo, V, tau, scratch, prof);"),
    ("entry arguments", """float* scratch, int max_ctas, void* stream) {
  size_t smem = 0;
  int e = prepare(hb2st_wave, n, b, &smem);""", """float* scratch, int max_ctas, long long* prof,
                               void* stream) {
  size_t smem = 0;
  int e = prepare(hb2st_wave, n, b, &smem);"""),
]
# the same grids with tasks that return at once: the launches alone
K8_EMPTY = [("empty task",
             "  if (!task_of(w, s_lo, n, b, T, s, t, i0)) return;\n"
             "  const int L = min(b, n - i0), ld = b | 1, tid = threadIdx.x;\n"
             "  float* B = blocks(dyn, scratch, b, ld);",
             "  if (!task_of(w, s_lo, n, b, T, s, t, i0) || w >= 0) return;\n"
             "  const int L = min(b, n - i0), ld = b | 1, tid = threadIdx.x;\n"
             "  float* B = blocks(dyn, scratch, b, ld);")]


# K8 in its one-launch design: the persistent loop (chase_flow.cuh) stamps each
# task's waits, stages and publishes, the task body (hb2st_chase.cu) its
# passes; thread 0 sums cycles and takes the global clock at five points
K8F_PHASES = ["wait_done_t+1", "early_fetch", "early_right_apply",
              "wait_stage_t+2", "last_row+larfg+left_sums",
              "left_update+store", "publish_stage", "wait_done_t+2",
              "D_stage", "publish_done"]


def _k8f_mark(q: int, who: str = "task.") -> str:
    return (f"if (threadIdx.x == 0) {{ long long c2 = clock64(); {who}q[{q}] "
            f"+= c2 - {who}ck; {who}ck = c2; }}")


K8F_LOOP = [
    ("kernel arguments",
     "chase_flow(const Task task0, unsigned* cnt) {",
     "chase_flow(const Task task0, unsigned* cnt, long long* prof) {"),
    ("task loop", """    for (int t = 0; t < ts; ++t) {
      if (s > 0) wait_counts(done + s - 1, min(t + 1, tp), nullptr, 0);
      task.early(s, t, dyn);
      if (s > 0) wait_counts(stage + s - 1, min(t + 2, tp), nullptr, 0);
      task.first(s, t, dyn);
      publish(stage + s, t + 1);
      if (s > 0) wait_counts(done + s - 1, min(t + 2, tp), nullptr, 0);
      task.second(s, t, dyn);
      publish(done + s, t + 1);
    }""", """    for (int t = 0; t < ts; ++t) {
      for (int u = 0; u < 10; ++u) task.q[u] = 0;
      unsigned long long g[5];
      g[0] = df::now_ns();
      task.ck = clock64();
      if (s > 0) wait_counts(done + s - 1, min(t + 1, tp), nullptr, 0);
      """ + _k8f_mark(0) + """
      g[1] = df::now_ns();
      task.early(s, t, dyn);
      """ + _k8f_mark(2) + """
      if (s > 0) wait_counts(stage + s - 1, min(t + 2, tp), nullptr, 0);
      """ + _k8f_mark(3) + """
      task.first(s, t, dyn);
      """ + _k8f_mark(5) + """
      publish(stage + s, t + 1);
      """ + _k8f_mark(6) + """
      g[2] = df::now_ns();
      if (s > 0) wait_counts(done + s - 1, min(t + 2, tp), nullptr, 0);
      """ + _k8f_mark(7) + """
      g[3] = df::now_ns();
      task.second(s, t, dyn);
      """ + _k8f_mark(8) + """
      publish(done + s, t + 1);
      """ + _k8f_mark(9) + """
      g[4] = df::now_ns();
      if (threadIdx.x == 0) {
        long long* p = prof + (static_cast<size_t>(s) * task.T + t) * 16;
        for (int u = 0; u < 10; ++u) p[u] = task.q[u];
        for (int u = 0; u < 5; ++u) p[10 + u] = static_cast<long long>(g[u]);
      }
    }"""),
    ("launch arguments", "void* args[] = {&arg, &cnt};",
     "long long* prof = arg.prof;\n  void* args[] = {&arg, &cnt, &prof};"),
]
K8F_BODY = [
    ("task state", "  float tv, tp, sq;\n",
     "  float tv, tp, sq;\n  long long* prof;\n  long long q[10];\n  long long ck;\n"),
    ("early fetch", """    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
""", """    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
    """ + _k8f_mark(1, "") + "\n"),
    ("column sums", """      sh.y[k] = w;
    }
    __syncthreads();
""", """      sh.y[k] = w;
    }
    __syncthreads();
    """ + _k8f_mark(4, "") + "\n"),
    ("profile buffer", "  task.scratch = scratch;\n",
     "  task.scratch = scratch;\n  task.prof = g_prof;\n"),
    ("entry arguments", """extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, void* stream) {""",
     """extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, long long* prof, void* stream) {
  g_prof = prof;"""),
    ("profile pointer", "template <int J>\ncudaError_t run(",
     "long long* g_prof = nullptr;\n\ntemplate <int J>\ncudaError_t run("),
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


def split_chase(root: Path, out: Path, label: str, smi: str) -> None:
    """K8 in the design the checkout has: one launch per wave in a tree
    whose ``band_chase.cu`` still holds ``hb2st_wave`` (a ``--root``
    before K8's redesign: the baseline its split is measured against),
    else the one-launch design (:func:`split_chase_flow`)."""
    import numpy as np
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "band_chase.cu").read_text()
    if "hb2st_wave(" not in src:
        split_chase_flow(root, out, label, smi)
        return
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, points in (("split", K8_POINTS), ("empty", K8_EMPTY)):
        fn = build(instrument(src, points, "band_chase"), out,
                   f"k8_{name}", csrc).slate_hb2st_f32
        fn.argtypes = (P, I, I, P, P, P, I) + ((P,) if name == "split"
                                              else ()) + (P,)
        fn.restype = I
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(8)
    for n in (8192, 4096):
        b = 128
        S, T = n - 1, (n - 2) // b + 1
        ab = torch.randn(b + 1, n, generator=gen, device="cuda")
        prof = torch.zeros(S * T * 10, dtype=torch.int64, device="cuda")
        scratch = torch.empty(1, device="cuda")
        maxc = K._chase_ctas(n, b)

        def run(name):
            rib = K.band_bulge.ribbon(ab, upper=False)
            V, tau = ab.new_zeros((S, T, b)), ab.new_zeros((S, T))
            extra = (P(prof.data_ptr()),) if name == "split" else ()
            rc = fns[name](P(rib.data_ptr()), n, b, P(V.data_ptr()),
                           P(tau.data_ptr()), P(scratch.data_ptr()), maxc,
                           *extra, P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K8 launch error {rc}")
            d, e = K.band_bulge.ribbon_diagonals(rib, n, b, upper=False)
            return d, e, V, tau
        got = run("split")
        want = K.hb2st_chase(ab)
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, want))
        ms = events_ms(lambda: run("split"), reps=3)
        committed_ms = events_ms(lambda: K.hb2st_chase(ab), reps=3)
        empty_ms = events_ms(lambda: run("empty"), reps=3)
        prof.zero_()
        run("split")
        torch.cuda.synchronize()
        pr = prof.view(S, T, 10).cpu().numpy().astype(np.float64)
        s_ix, t_ix = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
        live = (s_ix + 1 + t_ix * b) <= n - 1
        start, end = pr[..., 8], pr[..., 9]
        dur = end - start
        # cycles per ns of the SM clock, from the tasks' own spans
        ghz = float(pr[..., :8][live].sum() / dur[live].sum())
        wave = (2 * s_ix + t_ix)[live]
        nw = int(wave.max()) + 1
        w_lo = np.full(nw, np.inf)
        w_hi = np.zeros(nw)
        w_long = np.zeros(nw)
        np.minimum.at(w_lo, wave, start[live])
        np.maximum.at(w_hi, wave, end[live])
        np.maximum.at(w_long, wave, dur[live])
        has = np.isfinite(w_lo)  # waves with a task
        w_lo, w_hi, w_long = w_lo[has], w_hi[has], w_long[has]
        span_us = float((w_hi[-1] - w_lo[0]) / 1e3)
        longest_us = float(w_long.sum() / 1e3)
        gaps_us = float(np.clip(w_lo[1:] - w_hi[:-1], 0, None).sum() / 1e3)
        mid = S // 2
        row = live[mid] & (np.arange(T) >= 1)
        t0 = live[:, 0]

        def phases(sel):
            return {k: float(v) / ghz / 1e3
                    for k, v in zip(K8_PHASES, pr[..., :8][sel].mean(0))}
        print(json.dumps(dict(
            kernel="hb2st", design="wave", shape=[n, b], waves=int(has.sum()),
            bitwise_equal_to_committed=same, ms=ms, committed_ms=committed_ms,
            us_per_wave=committed_ms * 1e3 / nw, empty_tasks_ms=empty_ms,
            empty_us_per_wave=empty_ms * 1e3 / nw, sm_clock_ghz=ghz,
            span_us=span_us, sum_longest_task_us=longest_us,
            gap_us=span_us - longest_us, gaps_between_waves_us=gaps_us,
            mean_task_us=float(dur[live].mean() / 1e3),
            middle_sweep_task_us=phases(
                (s_ix == mid) & (t_ix >= 1) & live),
            middle_sweep_task_total_us=float(dur[mid][row].mean() / 1e3),
            t0_task_us=phases((t_ix == 0) & live),
            t0_task_total_us=float(dur[:, 0][t0].mean() / 1e3),
            label=label, device=smi)), flush=True)
        del prof, ab


def split_chase_flow(root: Path, out: Path, label: str, smi: str) -> None:
    """K8 in its one-launch design: each task's waits, passes and
    publishes (µs, the middle sweep's tasks with t ≥ 1 and the t = 0
    tasks), the time from a done[] publish to the start of the part that
    waits for it, and the lag between a sweep and the next at the middle
    t."""
    import numpy as np
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    (out / "chase_flow.cuh").write_text(instrument(
        (csrc / "chase_flow.cuh").read_text(), K8F_LOOP, "chase_flow"))
    fn = build(instrument((csrc / "hb2st_chase.cu").read_text(), K8F_BODY,
                          "hb2st_chase"), out, "k8_flow", csrc).slate_hb2st_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = (P, I, I, P, P, P, I, P, P, P)
    fn.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(8)
    for n in (8192, 4096):
        b = 128
        S, T = n - 1, (n - 2) // b + 1
        ab = torch.randn(b + 1, n, generator=gen, device="cuda")
        prof = torch.zeros(S * T * 16, dtype=torch.int64, device="cuda")
        scratch = torch.empty(1, device="cuda")

        def run():
            rib = K.band_bulge.ribbon(ab, upper=False)
            V, tau = ab.new_zeros((S, T, b)), ab.new_zeros((S, T))
            cnt = torch.zeros(2 * S, dtype=torch.int32, device="cuda")
            rc = fn(P(rib.data_ptr()), n, b, P(V.data_ptr()),
                    P(tau.data_ptr()), P(scratch.data_ptr()), sms,
                    P(cnt.data_ptr()), P(prof.data_ptr()),
                    P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K8 launch error {rc}")
            d, e = K.band_bulge.ribbon_diagonals(rib, n, b, upper=False)
            return d, e, V, tau
        got = run()
        want = K.hb2st_chase(ab)
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, want))
        ms = events_ms(run, reps=3)
        committed_ms = events_ms(lambda: K.hb2st_chase(ab), reps=3)
        prof.zero_()
        run()
        torch.cuda.synchronize()
        pr = prof.view(S, T, 16).cpu().numpy().astype(np.float64)
        s_ix, t_ix = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
        live = (s_ix + 1 + t_ix * b) <= n - 1
        g = pr[..., 10:15]
        span = g[..., 4] - g[..., 0]
        ghz = float(pr[..., :10][live].sum() / span[live].sum())
        mid = S // 2

        def phases(sel):
            return {k: float(v) / ghz / 1e3
                    for k, v in zip(K8F_PHASES, pr[..., :10][sel].mean(0))}
        # (s, t) with s >= 1 whose (s - 1, t + 1) exists
        s1, t1 = np.nonzero(live[1:, :-1] & live[:-1, 1:])
        s1 = s1 + 1
        lat1 = g[s1, t1, 1] - g[s1 - 1, t1, 4]
        lat2 = g[s1, t1, 3] - g[s1 - 1, t1 + 1, 4]
        t_mid = T // 2
        sw = np.arange(1, S)
        sw = sw[live[sw, t_mid]]
        lag = np.diff(g[sw, t_mid, 1]) / 1e3
        row = live[mid] & (np.arange(T) >= 1)
        print(json.dumps(dict(
            kernel="hb2st", design="dataflow", shape=[n, b],
            bitwise_equal_to_committed=same, ms=ms, committed_ms=committed_ms,
            sm_clock_ghz=ghz,
            middle_sweep_task_us=phases((s_ix == mid) & (t_ix >= 1) & live),
            middle_sweep_task_total_us=float(span[mid][row].mean() / 1e3),
            t0_task_us=phases((t_ix == 0) & live),
            done_t1_publish_to_early_start_us_median=float(
                np.median(lat1) / 1e3),
            done_t2_publish_to_stage2_start_us_median=float(
                np.median(lat2) / 1e3),
            sweep_lag_us_median=float(np.median(lag)),
            label=label, device=smi)), flush=True)
        del prof, ab


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
    split_chase(root, out, args.label, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
