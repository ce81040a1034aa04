#!/usr/bin/env python3
"""Split the column step of the by-index panel LU (K4), of the
physical-swap panel LU (K10) and of the Householder subpanel QR (K6), the
block step of the unpivoted tile LU (K7) and the task of the two bulge
chases (K8, K9) of ``slate_tpu_torch`` into phases, and time the right
triangular solve (K2) and the panel transpose (K5) against variants of
their designs, on one CUDA card.

    python3 tools/kernel_split.py [--root DIR] [--label NAME]
                                  [--only plu,k2,swap,lu,qr,chase,k5]

``ncu`` does not run where the card is, so the split is taken inside the
kernels: the script copies the sources of the checkout DIR (default: this
one) into ``DIR/slate_tpu_torch/_build/split/``, adds ``clock64()``
counters at fixed points of the copies (thread 0 of each CTA, or of each
task, sums the cycles of each phase into a device array) or K2's
variants, builds each copy with ``nvcc`` into a library of its own and
runs it. The committed sources are never changed. Each kernel is split in
the design the checkout has, so a ``--root`` of an earlier commit splits
the design this one replaced:

* K4 at its callers' shapes ([8, 1024, 2048] block 0, [8, 128, 2048],
  [1, 128, 7424]) and K10 at hesv's panel heights [16128, 256], [8192,
  256], [2048, 256] and [256, 256], each with a grid barrier per column
  or with tagged candidate words and a deferred trailing update;
* K6 at [16384, 128] with grids of 132, 66 and 44 CTAs, [13312, 128]
  from d0 = 896 and [384, 128] from d0 = 128: with a grid barrier per
  column (up to commit 274cf77: partials, publish, barrier, the flat
  reduction, one-thread larfg, update) or with the two-level exchange of
  tagged words (larfg and tw, the pass over the rows, the partials'
  barrier and publish, the owners' wait and sums, the wait for the sums),
  and then timed beside copies that update 2 or 8 rows a warp at once
  (the committed kernel: 4);
* K7 (its dataflow design) at [1024, 1024];
* K9 in its design of one launch per wave (``tb2bd_wave``, up to commit
  274cf77) at (n, band) = (8192, 128) and (4096, 128): each task's phases
  (B load, the previous U-side reflector's left-apply, ``larfg`` of v,
  its right-apply, B's store, D's load, D's right-apply, ``larfg`` of u,
  its left-apply, the stores; a barrier closes each phase) for the
  middle sweep's tasks and the t = 0 tasks, and the gap between waves
  (the waves' span minus their longest tasks) beside a copy whose tasks
  return at once (the launches alone);
* K8 and K9 in their one-launch design (``csrc/chase_flow.cuh``) at the
  same shapes: each task's three waits, its parts and publishes, the time
  from a done[] publish to the part that waits for it, and the lag
  between a sweep and the next;
* K5 (the panel transpose) beside copies that take one or four tiles a
  CTA, walk many tiles a CTA on a grid of the CTAs that fit, use 32×128
  or 128×32 tiles or streaming stores, at fold_panel's, unfold_panel's,
  the flat branch's and transpose_fold's shapes, each bit for bit to the
  plain version; beside a contiguous copy of the same bytes
  (``Tensor.copy_`` and a 16-byte copy kernel) and an empty kernel;
* K2's variants (its inverse formed at each tile task's start into a
  third shared buffer, the inverse tasks skipped; 64-row blocks at every
  m; 128-row blocks at every m) beside the committed K2 at the posv panel
  heights B [1024·k, 1024], k = 1 … 15, each with its relative error to
  the plain version.

Each instrumented copy's output is checked against the tree's plain
version (K4 and K10 bit for bit, K6 within 1e-5) or the committed
kernel's (K8, K9 bit for bit). One JSON line a shape: the instrumented
kernel's time (CUDA events, median of 5, 3 for the chases), and per
column, block step or task the time of each phase, its share of the
counted cycles applied to the measured time (the chases: cycles over the
SM clock). The counters cost time of their own, so compare phases within
one line. The probe points are found by text: a source they no longer
match stops the script with the point's name.
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


# K6 with a grid barrier per column (up to commit 274cf77): (partial sums,
# their publish, grid barrier, the reduction of every CTA's partials,
# larfg by one thread, the column and trailing update); the copy also
# takes the grid size
QR_GRID = ("grid", ["partials", "publish", "grid_barrier", "reduce",
                    "larfg", "update"], [
    ("kernel arguments", "float* part, float* head, int R, int RP) {",
     "float* part, float* head, int R, int RP, long long* prof) {\n"
     "  long long q[8] = {};\n  long long ck = clock64();"),
    ("column start", "    const int slot = j & 1;",
     "    if (threadIdx.x == 0) ck = clock64();\n    const int slot = j & 1;"),
    ("partials", """      red[half][k] = acc0 + acc1;
    }
    __syncthreads();""", """      red[half][k] = acc0 + acc1;
    }
    __syncthreads();
    """ + _mark(0)),
    ("grid barrier", "    grid.sync();\n",
     "    __syncthreads();\n    " + _mark(1) + "\n    grid.sync();\n    "
     + _mark(2) + "\n"),
    ("reduce", """    if (half == 0 && k >= j) s[k] = red[0][k] + red[1][k];
    __syncthreads();""", """    if (half == 0 && k >= j) s[k] = red[0][k] + red[1][k];
    __syncthreads();
    """ + _mark(3)),
    ("larfg", """    __syncthreads();
    const float beta = sc[0], t = sc[1], vden = sc[2];""", """    __syncthreads();
    """ + _mark(4) + """
    const float beta = sc[0], t = sc[1], vden = sc[2];"""),
    ("update", """      sx[c * RP + i] -= v * tw[c];
    }
    __syncthreads();
  }""", """      sx[c * RP + i] -= v * tw[c];
    }
    __syncthreads();
    """ + _mark(5) + """
  }
  if (tid == 0) for (int z = 0; z < 8; ++z) prof[g * 8 + z] = q[z];"""),
    ("entry arguments", """float* part, float* head, int max_ctas,
                                     void* stream) {""",
     """float* part, float* head, int max_ctas,
                                     int ctas, long long* prof, void* stream) {"""),
    ("grid size", "  int R = (hh + sms - 1) / sms;",
     "  int R = (hh + ctas - 1) / ctas;"),
    ("launch arguments", "&part, &head, &R, &RP};",
     "&part, &head, &R, &RP, &prof};"),
])
# K6 with tagged words and a two-level exchange (no grid barrier): larfg
# and tw in every thread, the pass over the CTA's rows by thread 0's warp,
# then the exchange: the partials' barrier, their publish, the owners' wait
# for every CTA's words (and its barrier), the owners' sums and publish,
# the wait for the sums and the diagonal row (and its barrier). The
# kernel's own q (an owner slot) keeps its name: the counters are qq.
def _qmark(q: int) -> str:
    return _mark(q, "qq", "threadIdx.x")


QR_TAGGED = ("tagged", ["larfg+tw", "pass", "partials_barrier", "publish",
                        "owner_wait", "owner_sums", "sum_wait"], [
    ("kernel arguments",
     "unsigned long long* scratch, int R, int RP, unsigned epoch) {",
     "unsigned long long* scratch, int R, int RP, unsigned epoch, "
     "long long* prof) {\n  long long qq[8] = {};\n  long long ck = clock64();"),
    ("exchange arguments", """__device__ void exchange(Shared& sh, const Words& ws, int g, int G, int c, unsigned tag,
                         int kl, int q) {""",
     """__device__ void exchange(Shared& sh, const Words& ws, int g, int G, int c, unsigned tag,
                         int kl, int q, long long* qq, long long& ck) {"""),
    ("partials barrier", """  __syncthreads();
  if (tid < W && tid >= c) {
    float s = sh.part[0][tid];""", """  __syncthreads();
  """ + _qmark(2) + """
  if (tid < W && tid >= c) {
    float s = sh.part[0][tid];"""),
    ("owner wait", """  const int own = (W - 1 - g) / G + 1;  // columns g, g + G, ... below W""",
     "  " + _qmark(3) + """
  const int own = (W - 1 - g) / G + 1;  // columns g, g + G, ... below W"""),
    ("owner sums", """  __syncthreads();
  if (g < W)
    for (int m = wp; m < own; m += NW) {""", """  __syncthreads();
  """ + _qmark(4) + """
  if (g < W)
    for (int m = wp; m < own; m += NW) {"""),
    ("sum wait", """  if (tid < W && tid >= c) sh.s[tid] = wait_word(ws.sum + par * W + tid, tag);""",
     "  " + _qmark(5) + """
  if (tid < W && tid >= c) sh.s[tid] = wait_word(ws.sum + par * W + tid, tag);"""),
    ("exchange end", """    sh.hrow[tid - W] = wait_word(ws.row + par * W + tid - W, tag);
  __syncthreads();
}""", """    sh.hrow[tid - W] = wait_word(ws.row + par * W + tid - W, tag);
  __syncthreads();
  """ + _qmark(6) + """
}"""),
    ("first exchange", "exchange(sh, ws, g, G, 0, col_tag(epoch, 0), kl, q);",
     "exchange(sh, ws, g, G, 0, col_tag(epoch, 0), kl, q, qq, ck);"),
    ("column start", """  for (int j = 0; j < jn; ++j) {
    // every thread alike""", """  for (int j = 0; j < jn; ++j) {
    if (threadIdx.x == 0) ck = clock64();
    // every thread alike"""),
    ("pass start", """    float acc[4] = {};
    const int ilo = max(0, j - r0);""", "    " + _qmark(0) + """
    float acc[4] = {};
    const int ilo = max(0, j - r0);"""),
    ("pass end", "    if (!next) break;", "    " + _qmark(1) + "\n    if (!next) break;"),
    ("column exchange", "    exchange(sh, ws, g, G, jx, tagn, kl, q);",
     "    exchange(sh, ws, g, G, jx, tagn, kl, q, qq, ck);"),
    ("kernel end", """  if (g == 0)
    for (int j = jn + tid; j < W; j += NTH) tau[j] = 0.f;""",
     """  if (tid == 0) for (int z = 0; z < 8; ++z) prof[g * 8 + z] = qq[z];
  if (g == 0)
    for (int j = jn + tid; j < W; j += NTH) tau[j] = 0.f;"""),
    ("entry arguments", """unsigned long long* scratch, int ctas, unsigned epoch,
                                     void* stream) {""",
     """unsigned long long* scratch, int ctas, unsigned epoch,
                                     long long* prof, void* stream) {"""),
    ("launch arguments", "&scratch, &R, &RP, &epoch};",
     "&scratch, &R, &RP, &epoch, &prof};"),
])


def QR_WORDS(G: int) -> int:
    """Words of K6's scratch for a grid of G (csrc/panel_qr.cu)."""
    return (2 * G + 4) * 128


# K6's (h, d0, G): geqrf's first subpanel at three grid sizes, a later
# one, gels' short one
QR_SHAPES = ((16384, 0, 132), (16384, 0, 66), (16384, 0, 44),
             (13312, 896, 66), (384, 128, 66))

# K9's task in its former design of one launch per wave (``tb2bd_wave`` in
# ``csrc/band_chase.cu`` up to commit 274cf77, for ``--root`` of such a
# tree): thread 0 sums each phase's cycles and takes the task's start and
# end on the global clock; a barrier closes every phase
_K9_MARK = {q: _mark(q) for q in range(10)}
K9_WAVE_PHASES = ["B_load", "left_apply_prev_u", "larfg_v",
                  "right_apply_v", "B_store", "D_load", "D_right_apply",
                  "larfg_u", "D_left_apply", "D_V_tau_store"]
K9_WAVE_POINTS = [
    ("kernel", "__global__ void __launch_bounds__(NTH)\ntb2bd_wave(",
     """__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(NTH)
tb2bd_wave("""),
    ("kernel arguments", """float* scratch) {
  extern __shared__ float dyn[];
  __shared__ Vectors sh;
  int s, t, c0;
  if (!task_of(w, s_lo, n, b, T, s, t, c0)) return;""",
     """float* scratch, long long* prof) {
  extern __shared__ float dyn[];
  __shared__ Vectors sh;
  int s, t, c0;
  if (!task_of(w, s_lo, n, b, T, s, t, c0)) return;
  long long q[10] = {};
  const unsigned long long ns0 = gtime();
  long long ck = clock64();"""),
    ("seed row", """    for (int k = tid; k < L; k += NTH) v[k] = R.at(s, c0 + k);
    __syncthreads();
    larfg(v, L, sh.sc);
    const float beta = sh.sc[0];
    for (int k = tid; k < L; k += NTH) R.at(s, c0 + k) = k == 0 ? beta : 0.f;""",
     """    for (int k = tid; k < L; k += NTH) v[k] = R.at(s, c0 + k);
    __syncthreads();
    """ + _K9_MARK[0] + """
    larfg(v, L, sh.sc);
    """ + _K9_MARK[2] + """
    const float beta = sh.sc[0];
    for (int k = tid; k < L; k += NTH) R.at(s, c0 + k) = k == 0 ? beta : 0.f;
    __syncthreads();
    """ + _K9_MARK[4]),
    ("B load", """    const float tp = tauu[task - 1];
    __syncthreads();""", """    const float tp = tauu[task - 1];
    __syncthreads();
    """ + _K9_MARK[0]),
    ("left-apply", """      B[i * ld + k] -= (tp * u[i]) * sh.w[k];
    }
    __syncthreads();""", """      B[i * ld + k] -= (tp * u[i]) * sh.w[k];
    }
    __syncthreads();
    """ + _K9_MARK[1]),
    ("larfg v", """    larfg(v, L, sh.sc);
    const float beta = sh.sc[0], tv = sh.sc[1];""", """    larfg(v, L, sh.sc);
    """ + _K9_MARK[2] + """
    const float beta = sh.sc[0], tv = sh.sc[1];"""),
    ("right-apply", """      else B[i * ld + k] -= (tv * sh.w[i - 1]) * v[k];
    }
    __syncthreads();
    store(B, ld, R, r0, b, c0, L);""", """      else B[i * ld + k] -= (tv * sh.w[i - 1]) * v[k];
    }
    __syncthreads();
    """ + _K9_MARK[3] + """
    store(B, ld, R, r0, b, c0, L);
    __syncthreads();
    """ + _K9_MARK[4]),
    ("D load", """  load(D, ld, R, c0, L, c0, L);
  __syncthreads();""", """  load(D, ld, R, c0, L, c0, L);
  __syncthreads();
  """ + _K9_MARK[5]),
    ("D right-apply", """  for (int i = tid; i < L; i += NTH) u[i] = D[i * ld];
  __syncthreads();
  larfg(u, L, sh.sc);""", """  for (int i = tid; i < L; i += NTH) u[i] = D[i * ld];
  __syncthreads();
  """ + _K9_MARK[6] + """
  larfg(u, L, sh.sc);
  """ + _K9_MARK[7]),
    ("D left-apply", """    else D[i * ld + k] -= (tu * u[i]) * sh.w[k - 1];
  }
  __syncthreads();""", """    else D[i * ld + k] -= (tu * u[i]) * sh.w[k - 1];
  }
  __syncthreads();
  """ + _K9_MARK[8]),
    ("task end", """    tauu[task] = tu;
  }
}""", """    tauu[task] = tu;
  }
  __syncthreads();
  """ + _K9_MARK[9] + """
  if (tid == 0) {
    long long* p = prof + task * 12;
    for (int z = 0; z < 10; ++z) p[z] = q[z];
    p[10] = static_cast<long long>(ns0);
    p[11] = static_cast<long long>(gtime());
  }
}"""),
    ("launch", "(R, n, b, T, w, s_lo, Vu, tauu, Vv, tauv, scratch);",
     "(R, n, b, T, w, s_lo, Vu, tauu, Vv, tauv, scratch, prof);"),
    ("entry arguments", "float* tauv, float* scratch, int max_ctas, void* stream) {",
     "float* tauv, float* scratch, int max_ctas, long long* prof,\n"
     "                               void* stream) {"),
]
# the same grids with tasks that return at once: the launches alone
K9_WAVE_EMPTY = [("empty task",
                  "  if (!task_of(w, s_lo, n, b, T, s, t, c0)) return;\n",
                  "  if (!task_of(w, s_lo, n, b, T, s, t, c0) || w >= 0) return;\n")]


# K8 and K9 in their one-launch design: the persistent loop
# (chase_flow.cuh) stamps each task's waits, parts and publishes, the task
# bodies (hb2st_chase.cu, band_chase.cu) a point inside some parts; thread
# 0 sums cycles and takes the global clock at five points. Phase q of a
# task: 0 the wait for done[s - 1] >= t + 1, 1 and 2 the early part (to the
# body's mark, then the rest), 3 the wait for stage[s - 1] >= t + 2, 4 and
# 5 the rest of stage 1, 6 its publish, 7 the part between the stages, 8 the
# wait for done[s - 1] >= t + 2, 9 and 10 stage 2, 11 its publish.
FLOW_PHASES = {
    "hb2st": ["wait_done_t+1", "early_fetch", "early_right_apply",
              "wait_stage_t+2", "last_row+larfg+left_sums",
              "left_update+store", "publish_stage", "mid",
              "wait_done_t+2", "-", "D_stage", "publish_done"],
    "tb2bd": ["wait_done_t+1", "early_fetch", "early_left_apply_prev_u",
              "wait_stage_t+2", "late_loads+larfg_v", "B_right_apply+store",
              "publish_stage", "mid_D_right_apply", "wait_done_t+2",
              "last_row+norm", "u_left_apply+store+packs", "publish_done"],
}


def _flow_mark(q: int, who: str = "task.") -> str:
    return (f"if (threadIdx.x == 0) {{ long long c2 = clock64(); {who}q[{q}] "
            f"+= c2 - {who}ck; {who}ck = c2; }}")


FLOW_LOOP = [
    ("kernel arguments",
     "chase_flow(const Task task0, unsigned* cnt) {",
     "chase_flow(const Task task0, unsigned* cnt, long long* prof) {"),
    ("task loop", """    for (int t = 0; t < ts; ++t) {
      if (s > 0) wait_counts(done + s - 1, min(t + 1, tp), nullptr, 0);
      task.early(s, t, dyn);
      if (s > 0) wait_counts(stage + s - 1, min(t + 2, tp), nullptr, 0);
      task.first(s, t, dyn);
      publish(stage + s, t + 1);
      task.mid(s, t, dyn);
      if (s > 0) wait_counts(done + s - 1, min(t + 2, tp), nullptr, 0);
      task.second(s, t, dyn);
      publish(done + s, t + 1);
    }""", """    for (int t = 0; t < ts; ++t) {
      for (int u = 0; u < 12; ++u) task.q[u] = 0;
      unsigned long long g[5];
      g[0] = df::now_ns();
      task.ck = clock64();
      if (s > 0) wait_counts(done + s - 1, min(t + 1, tp), nullptr, 0);
      """ + _flow_mark(0) + """
      g[1] = df::now_ns();
      task.early(s, t, dyn);
      """ + _flow_mark(2) + """
      if (s > 0) wait_counts(stage + s - 1, min(t + 2, tp), nullptr, 0);
      """ + _flow_mark(3) + """
      task.first(s, t, dyn);
      """ + _flow_mark(5) + """
      publish(stage + s, t + 1);
      """ + _flow_mark(6) + """
      task.mid(s, t, dyn);
      """ + _flow_mark(7) + """
      g[2] = df::now_ns();
      if (s > 0) wait_counts(done + s - 1, min(t + 2, tp), nullptr, 0);
      """ + _flow_mark(8) + """
      g[3] = df::now_ns();
      task.second(s, t, dyn);
      """ + _flow_mark(10) + """
      publish(done + s, t + 1);
      """ + _flow_mark(11) + """
      g[4] = df::now_ns();
      if (threadIdx.x == 0) {
        long long* p = prof + (static_cast<size_t>(s) * task.T_ + t) * 20;
        for (int u = 0; u < 12; ++u) p[u] = task.q[u];
        for (int u = 0; u < 5; ++u) p[12 + u] = static_cast<long long>(g[u]);
      }
    }"""),
    ("launch arguments", "void* args[] = {&arg, &cnt};",
     "long long* prof = arg.prof;\n  void* args[] = {&arg, &cnt, &prof};"),
]
_FLOW_STATE = ("task state", "  T tv, tp;\n  S sq;\n",
               "  T tv, tp;\n  S sq;\n  long long* prof;\n  long long q[12];\n"
               "  long long ck;\n")
_FLOW_PROF = [("profile buffer", "  task.b = b;\n",
               "  task.b = b;\n  task.prof = g_prof;\n"),
              ("profile pointer", "template <class T, int J>\ncudaError_t run(",
               "long long* g_prof = nullptr;\n\n"
               "template <class T, int J>\ncudaError_t run(")]
FLOW_BODY = {
    "hb2st": ("hb2st_chase.cu", "slate_hb2st_f32", [
        _FLOW_STATE,
        ("early fetch", """    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
""", """    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
    """ + _flow_mark(1, "") + "\n"),
        ("column sums", """      sh.y[k] = w;
    }
    __syncthreads();
""", """      sh.y[k] = w;
    }
    __syncthreads();
    """ + _flow_mark(4, "") + "\n"),
        *_FLOW_PROF,
        ("entry arguments", """extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, void* stream) {""",
         """extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, long long* prof, void* stream) {
  g_prof = prof;"""),
    ]),
    "tb2bd": ("band_chase.cu", "slate_tb2bd_f32", [
        _FLOW_STATE,
        ("early fetch", """    fetch(B, B + b * ld, ld, t > 0);
    __syncthreads();
""", """    fetch(B, B + b * ld, ld, t > 0);
    __syncthreads();
    """ + _flow_mark(1, "") + "\n"),
        ("v formed", """    __syncthreads();
    tv = sh.sc[1];""", """    __syncthreads();
    """ + _flow_mark(4, "") + """
    tv = sh.sc[1];"""),
        ("norm", """    if (lane == 0) sh.red[wp] = of_real<T>(sq);
    __syncthreads();
""", """    if (lane == 0) sh.red[wp] = of_real<T>(sq);
    __syncthreads();
    """ + _flow_mark(9, "") + "\n"),
        *_FLOW_PROF,
        ("entry arguments", """float* tauv, float* scratch, int max_ctas, unsigned* cnt,
                               void* stream) {""",
         """float* tauv, float* scratch, int max_ctas, unsigned* cnt,
                               long long* prof, void* stream) {
  g_prof = prof;"""),
    ]),
}


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


def split_qr(root: Path, out: Path, label: str, smi: str) -> None:
    """K6's column by phase at :data:`QR_SHAPES` (grid size G as given),
    each run held to the tree's plain version within 1e-5 (relative
    Frobenius)."""
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "panel_qr.cu").read_text()
    design, names, points = QR_GRID if "grid.sync()" in src else QR_TAGGED
    fn = build(instrument(src, points, "panel_qr"), out, "split_qr",
               csrc).slate_qr_subpanel_f32
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    gen = torch.Generator(device="cuda").manual_seed(6)
    for h, d0, G in QR_SHAPES:
        a = torch.randn(h, 128, generator=gen, device="cuda")
        prof = torch.zeros(G * 8, dtype=torch.int64, device="cuda")
        tau = torch.empty(128, device="cuda")
        if design == "grid":
            fn.argtypes = (P, L, I, I, P, P, P, I, I, P, P)
            maxc = -(-(h - d0) // 32)
            bufs = [torch.empty(2 * maxc * 128, device="cuda"),
                    torch.empty(2 * 128, device="cuda")]
        else:
            fn.argtypes = (P, L, I, I, P, P, I, ctypes.c_uint, P, P)
            maxc = G
            bufs = [torch.zeros(QR_WORDS(G), dtype=torch.int64,
                                device="cuda")]
        epoch = [0]

        def run():
            x = a.clone()
            prof.zero_()
            if design == "grid":
                ex = (maxc, G)
            else:
                epoch[0] += 1
                ex = (G, epoch[0])
            rc = fn(P(x.data_ptr()), 128, h, d0, P(tau.data_ptr()),
                    *(P(t.data_ptr()) for t in bufs), *ex, P(prof.data_ptr()),
                    P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K6 launch error {rc}")
            return x
        x = run()
        ref = a.clone()
        tau_p = K.panel_qr_plain(ref, d0)
        err = max(float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)),
                  float(torch.linalg.norm(tau - tau_p)
                        / torch.linalg.norm(tau_p)))
        ms = events_ms(run)
        run()
        torch.cuda.synchronize()
        R = max(32, -(-(h - d0) // G))
        g = -(-(h - d0) // R)
        p = prof.view(-1, 8)[:g, :len(names)].double().mean(0)
        us_col = ms * 1e3 / 128
        print(json.dumps(dict(
            kernel="panel_qr", design=design, shape=[h, 128], d0=d0,
            ctas=g, rows_per_cta=R, rel_err_to_plain=err, ms=ms,
            us_per_column=us_col,
            phases_us_per_column={n: float(v / p.sum()) * us_col
                                  for n, v in zip(names, p)},
            label=label, device=smi)), flush=True)

# K6 (the tagged design) with other numbers of rows a warp updates at once
QR_RB = {rb: [("rows at once", "constexpr int RB = 4;", f"constexpr int RB = {rb};")]
         for rb in (2, 8)}


def time_qr_variants(root: Path, out: Path, label: str, smi: str) -> None:
    """K6 as committed beside copies that update 2 or 8 rows a warp at
    once, at K6's three shapes on one CTA per SM, each within 1e-5 of the
    plain version."""
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "panel_qr.cu").read_text()
    if "constexpr int RB = 4;" not in src:
        return
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for rb, points in QR_RB.items():
        fn = build(instrument(src, points, "panel_qr"), out, f"qr_rb{rb}",
                   csrc).slate_qr_subpanel_f32
        fn.argtypes = (P, L, I, I, P, P, I, ctypes.c_uint, P)
        fn.restype = I
        fns[rb] = fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    scratch = torch.zeros(QR_WORDS(sms), dtype=torch.int64, device="cuda")
    epoch = [0]
    for h, d0 in ((16384, 0), (13312, 896), (384, 128)):
        a = torch.randn(h, 128, generator=gen, device="cuda")
        ref = a.clone()
        K.panel_qr_plain(ref, d0)
        x = a.clone()
        row = dict(kernel="panel_qr", design="rows_at_once", shape=[h, 128],
                   d0=d0, committed_rb=4,
                   committed_ms=events_ms(lambda: (x.copy_(a),
                                                   K.panel_qr(x, d0))))
        for rb, fn in fns.items():
            tau = torch.empty(128, device="cuda")

            def run():
                epoch[0] += 1
                x.copy_(a)
                rc = fn(P(x.data_ptr()), 128, h, d0, P(tau.data_ptr()),
                        P(scratch.data_ptr()), sms, epoch[0],
                        P(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise SystemExit(f"kernel_split: K6 launch error {rc}")
            run()
            row[f"rb{rb}_rel_err"] = float(torch.linalg.norm(x - ref)
                                           / torch.linalg.norm(ref))
            row[f"rb{rb}_ms"] = events_ms(run)
        print(json.dumps(dict(**row, label=label, device=smi)), flush=True)

def split_tb2bd_wave(root: Path, out: Path, label: str, smi: str) -> None:
    """K9 in its former design of one launch per wave (a ``--root`` whose
    ``band_chase.cu`` still holds ``tb2bd_wave``): each task's phases for
    the tasks of the middle sweep and for the t = 0 tasks, the
    instrumented copy's outputs held bit for bit to the committed
    kernel's, and the gap between waves (the waves' span minus the sum of
    their longest tasks, device clock) beside a copy whose tasks return
    at once (the launches alone, same grids)."""
    import numpy as np
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    src = (csrc / "band_chase.cu").read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, points in (("split", K9_WAVE_POINTS), ("empty", K9_WAVE_EMPTY)):
        fn = build(instrument(src, points, "band_chase"), out,
                   f"k9_{name}", csrc).slate_tb2bd_f32
        fn.argtypes = (P, I, I) + (P,) * 5 + (I,) + (
            (P,) if name == "split" else ()) + (P,)
        fn.restype = I
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(9)
    for n in (8192, 4096):
        b = 128
        S, T = n - 1, (n - 2) // b + 1
        ab = torch.randn(b + 1, n, generator=gen, device="cuda")
        prof = torch.zeros(S * T * 12, dtype=torch.int64, device="cuda")
        scratch = torch.empty(1, device="cuda")
        maxc = T // 2 + 2

        def run(name):
            rib = K.band_bulge.ribbon(ab, upper=True)
            packs = [ab.new_zeros(shape) for shape in
                     ((S, T, b), (S, T), (S, T, b), (S, T))]
            extra = (P(prof.data_ptr()),) if name == "split" else ()
            rc = fns[name](P(rib.data_ptr()), n, b,
                           *(P(x.data_ptr()) for x in packs),
                           P(scratch.data_ptr()), maxc, *extra,
                           P(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise SystemExit(f"kernel_split: K9 launch error {rc}")
            d, e = K.band_bulge.ribbon_diagonals(rib, n, b, upper=True)
            return (d, e, *packs)
        got = run("split")
        want = K.tb2bd_chase(ab)[:6]
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, want))
        ms = events_ms(lambda: run("split"), reps=3)
        committed_ms = events_ms(lambda: K.tb2bd_chase(ab), reps=3)
        empty_ms = events_ms(lambda: run("empty"), reps=3)
        prof.zero_()
        run("split")
        torch.cuda.synchronize()
        pr = prof.view(S, T, 12).cpu().numpy().astype(np.float64)
        s_ix, t_ix = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
        live = (s_ix + 1 + t_ix * b) <= n - 1
        start, end = pr[..., 10], pr[..., 11]
        dur = end - start
        # cycles per ns of the SM clock, from the tasks' own spans
        ghz = float(pr[..., :10][live].sum() / dur[live].sum())
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
        mid = S // 2
        row = live[mid] & (np.arange(T) >= 1)

        def phases(sel):
            return {k: float(v) / ghz / 1e3
                    for k, v in zip(K9_WAVE_PHASES, pr[..., :10][sel].mean(0))}
        print(json.dumps(dict(
            kernel="tb2bd", design="wave", shape=[n, b], waves=int(has.sum()),
            bitwise_equal_to_committed=same, ms=ms, committed_ms=committed_ms,
            us_per_wave=committed_ms * 1e3 / nw, empty_tasks_ms=empty_ms,
            sm_clock_ghz=ghz, span_us=span_us, sum_longest_task_us=longest_us,
            gap_us=span_us - longest_us,
            middle_sweep_task_us=phases(
                (s_ix == mid) & (t_ix >= 1) & live),
            middle_sweep_task_total_us=float(dur[mid][row].mean() / 1e3),
            t0_task_us=phases((t_ix == 0) & live),
            t0_task_total_us=float(dur[:, 0][live[:, 0]].mean() / 1e3),
            label=label, device=smi)), flush=True)
        del prof, ab


def split_chase_flow(root: Path, out: Path, label: str, smi: str) -> None:
    """K8 and K9 in their one-launch design: each task's waits, parts and
    publishes (µs, the middle sweep's tasks with t ≥ 1 and the t = 0
    tasks), the time from a done[] publish to the start of the part that
    waits for it, and the lag between a sweep and the next at the middle
    t; each instrumented copy's outputs held bit for bit to the committed
    kernel's."""
    import numpy as np
    import torch
    from slate_tpu_torch.internal import kernels as K
    csrc = root / "slate_tpu_torch/csrc"
    (out / "chase_flow.cuh").write_text(instrument(
        (csrc / "chase_flow.cuh").read_text(), FLOW_LOOP, "chase_flow"))
    P, I = ctypes.c_void_p, ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(8)
    for which, (source, symbol, points) in FLOW_BODY.items():
        upper = which == "tb2bd"
        fn = getattr(build(instrument((csrc / source).read_text(), points,
                                      source), out, f"flow_{which}", csrc),
                     symbol)
        npack = 4 if upper else 2
        fn.argtypes = (P, I, I) + (P,) * (npack + 1) + (I, P, P, P)
        fn.restype = I
        committed = K.tb2bd_chase if upper else K.hb2st_chase
        for n in (8192, 4096):
            b = 128
            S, T = n - 1, (n - 2) // b + 1
            ab = torch.randn(b + 1, n, generator=gen, device="cuda")
            prof = torch.zeros(S * T * 20, dtype=torch.int64, device="cuda")
            scratch = torch.empty(1, device="cuda")

            def run():
                rib = K.band_bulge.ribbon(ab, upper=upper)
                packs = [ab.new_zeros(shape) for shape in
                         ((S, T, b), (S, T)) * (npack // 2)]
                cnt = torch.zeros(2 * S, dtype=torch.int32, device="cuda")
                rc = fn(P(rib.data_ptr()), n, b,
                        *(P(x.data_ptr()) for x in packs),
                        P(scratch.data_ptr()), sms, P(cnt.data_ptr()),
                        P(prof.data_ptr()),
                        P(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise SystemExit(f"kernel_split: {which} launch error {rc}")
                d, e = K.band_bulge.ribbon_diagonals(rib, n, b, upper=upper)
                return (d, e, *packs)
            got = run()
            want = committed(ab)
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(got, want))
            ms = events_ms(run, reps=3)
            committed_ms = events_ms(lambda: committed(ab), reps=3)
            prof.zero_()
            run()
            torch.cuda.synchronize()
            pr = prof.view(S, T, 20).cpu().numpy().astype(np.float64)
            s_ix, t_ix = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
            live = (s_ix + 1 + t_ix * b) <= n - 1
            g = pr[..., 12:17]
            span = g[..., 4] - g[..., 0]
            ghz = float(pr[..., :12][live].sum() / span[live].sum())
            mid = S // 2
            names = FLOW_PHASES[which]

            def phases(sel):
                return {k: float(v) / ghz / 1e3
                        for k, v in zip(names, pr[..., :12][sel].mean(0))
                        if k != "-"}
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
                kernel=which, design="dataflow", shape=[n, b],
                bitwise_equal_to_committed=same, ms=ms,
                committed_ms=committed_ms, sm_clock_ghz=ghz,
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


def split_chase(root: Path, out: Path, label: str, smi: str) -> None:
    """K9 in its former design where the checkout still has it (a tree
    before K9's redesign), else both chasers in their one-launch design
    (:func:`split_chase_flow`)."""
    if "tb2bd_wave(" in (root / "slate_tpu_torch/csrc/band_chase.cu").read_text():
        split_tb2bd_wave(root, out, label, smi)
    else:
        split_chase_flow(root, out, label, smi)


# K5's design variants: (name, [(label, committed text, variant text)])
K5_GRID = "  const int grid = static_cast<int>((total + PER_CTA - 1) / PER_CTA);"
K5_VARIANTS = [
    ("committed", []),
    *[(f"{k} tile{'s' if k > 1 else ''} a CTA",
       [("tiles", "constexpr int PER_CTA = 2;", f"constexpr int PER_CTA = {k};")])
      for k in (1, 4)],
    # every CTA that fits on the card at once, each walking many tiles
    ("the CTAs that fit", [("grid", K5_GRID, """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_transpose, NT, 0);
  const long long fit = static_cast<long long>(sms) * per_sm;
  const long long each = (total + fit - 1) / fit;
  const int grid = static_cast<int>((total + each - 1) / each);""")]),
    ("32x128 tile", [("rows", "constexpr int TR = 64; ", "constexpr int TR = 32; "),
                     ("cols", "constexpr int TC = 64; ", "constexpr int TC = 128; ")]),
    ("128x32 tile", [("rows", "constexpr int TR = 64; ", "constexpr int TR = 128; "),
                     ("cols", "constexpr int TC = 64; ", "constexpr int TC = 32; ")]),
    ("streaming stores", [("store", "*reinterpret_cast<float4*>(dst) = make_float4(",
                           "__stcs(reinterpret_cast<float4*>(dst), make_float4(")
                          , ("store end", "o[j][3]);", "o[j][3]));")]),
]


def time_k5_variants(root: Path, out: Path, label: str, smi: str) -> None:
    """K5 (csrc/panel_transpose.cu) beside copies of it that change one
    part of its design, at fold_panel's [16384, 1024] window, unfold_panel's
    [8, 1024, 2048], the flat branch's [8448, 256] window and
    transpose_fold's [16384, 128], each checked bit for bit against the
    plain version; and a contiguous copy of the same bytes
    (``Tensor.copy_`` and a 16-byte copy kernel, :data:`COPY_SRC`), the
    most a pass of one read and one write reaches on this card, and an
    empty kernel, the floor of any launch so timed."""
    import torch
    from slate_tpu_torch.internal import kernels as K
    src = (root / "slate_tpu_torch/csrc/panel_transpose.cu").read_text()
    n, nb, fn_ = 16384, 1024, 8448
    a = torch.randn(n + 64, n, device="cuda")
    fl = torch.randn(fn_, fn_, device="cuda")
    sub = torch.randn(n, 128, device="cuda")
    win = a[64:, :nb]
    cases = [  # (shape, x, S, R, C, xr, xb, out shape, plain)
        ("fold_panel [16384, 1024] window", win, 8, n // 8, nb, win.stride(0),
         n // 8 * win.stride(0), (8, nb, n // 8), K.panel_fold_plain(win, 8)),
        ("transpose_tiled [8448, 256] window", fl[:, :256], 1, fn_, 256, fn_,
         0, (256, fn_), K.panel_fold_plain(fl[:, :256], 1)[0]),
        ("transpose_fold [16384, 128]", sub, 8, n // 8, 128, 128,
         n // 8 * 128, (8, 128, n // 8), K.panel_fold_plain(sub, 8)),
    ]
    pcf = K.panel_fold_plain(win, 8)
    cases.append(("unfold_panel [8, 1024, 2048]", pcf, 8, nb, n // 8, n // 8,
                  nb * n // 8, (n, nb), K.panel_unfold_plain(pcf)))
    for name, points in K5_VARIANTS:
        lib = build(instrument(src, points, name), out,
                    "k5_" + name.replace(" ", "_"),
                    root / "slate_tpu_torch/csrc")
        f = lib.slate_panel_transpose_f32
        f.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int) + (ctypes.c_longlong,) * 4 \
            + (ctypes.c_void_p,)
        f.restype = ctypes.c_int
        for shape, x, S, R, C, xr, xb, oshape, ref in cases:
            y = torch.empty(oshape, device="cuda")
            yr, yb = R, C * R

            def run():
                if f(x.data_ptr(), y.data_ptr(), S, R, C, xr, xb, yr, yb,
                     torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"K5 variant {name}: launch error")
            run()
            torch.cuda.synchronize()
            ms = events_ms(run, reps=7)
            print(json.dumps(dict(
                kernel="panel_transpose", variant=name, shape=shape, ms=ms,
                bound_ms=2 * x.numel() * 4 / 3.35e12 * 1e3,
                bitwise=bool(torch.equal(y, ref)), label=label, device=smi)),
                flush=True)
    src_c = torch.randn(n, nb, device="cuda")
    dst_c = torch.empty_like(src_c)
    lib = build(COPY_SRC, out, "k5_copy", root / "slate_tpu_torch/csrc")
    for fn_name in ("slate_copy16", "slate_empty"):
        getattr(lib, fn_name).restype = ctypes.c_int
    lib.slate_copy16.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p)
    lib.slate_empty.argtypes = (ctypes.c_void_p,)

    def copy16(per_sm):
        if lib.slate_copy16(src_c.data_ptr(), dst_c.data_ptr(),
                            src_c.numel() // 4, per_sm,
                            torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("copy kernel: launch error")
    runs = [("copy_", lambda: dst_c.copy_(src_c))]
    runs += [(f"16-byte copy kernel, {k} CTAs an SM",
              lambda k=k: copy16(k)) for k in (4, 8)]
    runs.append(("empty kernel", lambda: lib.slate_empty(
        torch.cuda.current_stream().cuda_stream)))
    for what, fn in runs:
        ms = events_ms(fn, reps=7)
        if what.startswith("16-byte"):
            assert torch.equal(dst_c, src_c)
        print(json.dumps(dict(
            kernel=what, shape=[n, nb], ms=ms,
            bound_ms=2 * src_c.numel() * 4 / 3.35e12 * 1e3, label=label,
            device=smi)), flush=True)


# A contiguous copy in 16-byte words, four loads of a thread in flight
# before its stores, on a grid of per_sm CTAs of 256 threads an SM; and an
# empty kernel: the most a pass of one read and one write reaches on the
# card, and what any launch costs, timed as K5 is.
COPY_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) copy16(const float4* __restrict__ x,
                                              float4* __restrict__ y,
                                              long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * step < n4; i += 4 * step) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[i + k * step];
#pragma unroll
    for (int k = 0; k < 4; ++k) y[i + k * step] = v[k];
  }
  for (; i < n4; i += step) y[i] = x[i];
}
__global__ void empty_kernel() {}
extern "C" int slate_copy16(const void* x, void* y, long long n4, int per_sm,
                            void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  copy16<<<sms * per_sm, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int slate_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def qr(root: Path, out: Path, label: str, smi: str) -> None:
    split_qr(root, out, label, smi)
    time_qr_variants(root, out, label, smi)


PARTS = {"plu": split_plu, "k2": time_k2_variants, "swap": split_swap,
         "lu": split_lu, "qr": qr, "chase": split_chase,
         "k5": time_k5_variants}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts: " + ", ".join(PARTS))
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
    for part in args.only.split(","):
        PARTS[part](root, out, args.label, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
