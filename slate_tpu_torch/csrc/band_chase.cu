// The upper band -> upper bidiagonal bulge chase (K9), in FP32:
//   slate_tb2bd_f32
//
// Replaces _tb2bd_vmem_jit (slate_tpu/internal/band_wave_vmem_bd.py:330) and
// computes the task DAG of the numpy twin (slate_tpu/internal/band_bulge.py,
// gebr task types): task (sweep s, chase t), c0 = s + 1 + t b, L = min(b, n - c0),
// works on its bulge block B = A[c0 - b : c0, c0 : c0 + L] (for t = 0 the
// row s, A[s, c0 : c0 + L]) and its diagonal block D = A[c0 : c0 + L, c0 : c0 + L]:
// it left-applies the previous task's U-side reflector to B (the fill),
// takes the V-side reflector v from B's row 0 and right-applies it to B's
// other rows and to D, then takes the U-side reflector u from D's column 0
// and left-applies it to D's other columns. Only u chains from task to task.
//
// The band lives in a ribbon in device memory: element (r, c) at
// rib[r (4b - 1) + c + 2b - 1] (17 MB at n = 8192, b = 128: resident in L2).
// The upper band and its fill span -(b - 1) <= c - r <= 2b - 1: D holds the
// fill below the diagonal that the next sweep chases, so D is a whole square.
//
// Bound on an H100: latency. A sweep trails the one before it by about two
// tasks, so the critical path is ~2n dependent task parts; the flops (~16 b^2
// a task, 1.0 ms at n = 8192, b = 128) and the bytes are far below it.
// Design, from the split of the design it replaces (one launch per wave, one
// CTA per task, four full-block passes; PERF.md section 6), K8's design
// (hb2st_chase.cu) on the same persistent loop (chase_flow.cuh):
//   * One cooperative launch for the whole chase: CTA x takes the sweeps x,
//     x + G, ...; a task waits on counters of the sweep before it, only for
//     what it reads. Of what task (s, t) reads, sweep s - 1 writes last: all
//     but B's last element (B[b - 1][L - 1], for t = 0 the last element of
//     row s) and D's last column in (s - 1, t); that element and D's last
//     column but its diagonal element in (s - 1, t + 1)'s first stage (its B
//     block); D's last diagonal element in (s - 1, t + 1)'s second stage.
//     These are K8's three waits with a last column for its last row
//     (tests/test_torch_band_chase_sched.py derives them from the element
//     sets). So the early part loads all but those and runs the deferred
//     left-apply of the previous u on all of B's columns but the last.
//   * Stage 1 takes the late element and D's last column, finishes B's last
//     column, forms v from row 0 in one warp and right-applies it to B's
//     rows, one warp a row, straight to the ribbon; after the publish (mid)
//     it right-applies v to D's rows but the last. Stage 2 takes D's last
//     diagonal element, right-applies the last row, forms u from column 0
//     (its norm summed across the CTA's warps) and left-applies it (column
//     sums per warp, then in warp order), straight to the ribbon.
//   * The loads of a part are in flight together (4 rows x 4 columns a
//     thread a batch, L2 loads), no run-time division in any loop, and every
//     reduction runs in a fixed order (a fixed butterfly, then the warps'
//     partials in warp order), so runs repeat bit for bit. The arithmetic is
//     band_bulge.tb2bd's (left-apply, larfg, right-apply on B; right-apply,
//     larfg, left-apply on D), each product and difference rounded once.
// Measured (PERF.md section 6, n = 8192, b = 128): 680 -> 166 ms a chase;
// a middle task takes 19.5 us with counters (early loads 6.0, the previous
// u's left-apply 2.4, late loads and v 1.1, B's right-apply and store 2.3,
// D's rows 1.2, the wait for (s - 1, t + 1) 1.0, u's left-apply and the
// stores 4.0), and consecutive sweeps start one task period apart.
// The blocks live in shared memory for bands up to 128 and in the global
// scratch the caller passes (two b x (b | 1) blocks per CTA) up to 256.
// larfg follows the twin: beta = -sign(alpha) ||x|| with sign(0) = +1;
// tau = 0 and beta = alpha when ||x[1:]|| = 0; v[0] = 1.

#include <cuda_runtime.h>

#include "chase_flow.cuh"

namespace {

using slate::chase::NTH;
using slate::chase::NW;
using slate::chase::Ribbon;
using slate::chase::warp_sum;
using slate::chase::warp_sums;
using slate::chase::warps_sum;

constexpr int BMAX = 256;       // widest band
constexpr int SMEM_BMAX = 128;  // widest band whose two blocks fit shared memory

struct Vectors {
  float x[BMAX];   // row s (t = 0), then D's column 0 after the right-apply
  float v[BMAX];   // the task's V-side reflector
  float u[BMAX];   // the task's U-side reflector
  float up[BMAX];  // the previous task's
  float w[BMAX];   // column sums: the previous u's left-apply, then u's
  float part[NW][BMAX];
  float red[NW];
  float sc[3];     // the last column's sum, tau_v, beta_v
};

__device__ __forceinline__ Vectors& vectors() {
  __shared__ Vectors sh;
  return sh;
}

// beta, tau and 1 / (alpha - beta)'s denominator of larfg from alpha and
// ||x[1:]||^2, as the twin computes them
struct Householder {
  float beta, tau, vden;
  __device__ __forceinline__ Householder(float alpha, float xn) {
    beta = alpha;
    tau = 0.f;
    vden = 1.f;
    if (xn != 0.f) {
      const float sgn = alpha < 0.f ? -1.f : 1.f;
      beta = -sgn * sqrtf(alpha * alpha + xn);
      tau = (beta - alpha) / beta;
      vden = alpha - beta;
    }
  }
};

// J column slots a lane (b <= 32 J): K9 with its blocks in shared memory
// (J = 4) or in global scratch (J = 8).
template <int J>
struct Tb2bd {
  static constexpr int U = J * 2;    // row slots a warp: rows w + NW u, u < U
  static constexpr int UB = 16 / J;  // rows a warp loads in one batch
  static constexpr int RG = 32 / J;  // rows a warp reduces at once
  Ribbon R;
  int n, b, T;
  float* Vu;
  float* tauu;
  float* Vv;
  float* tauv;
  float* scratch;
  // a thread's state from one stage or task to the next
  int c0, L;
  float tv, tp, sq;

  __device__ __forceinline__ float* blockB(float* dyn) const {
    const int ld = b | 1;
    return J * 32 <= SMEM_BMAX ? dyn : scratch + static_cast<size_t>(blockIdx.x) * 2 * b * ld;
  }

  // B's rows (t >= 1) but its last element and D's rows but their last
  // column, loaded into registers in batches of UB rows a warp whose loads
  // are all in flight at once, then stored.
  __device__ __forceinline__ void fetch(float* B, float* D, int ld, bool chase) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, lc = L - 1;
    for (int u0 = 0; u0 < U; u0 += UB) {
      float rb[UB][J], rd[UB][J];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          const bool inb = chase && i < b && k < L && !(i == b - 1 && k == lc);
          rb[u][j] = inb ? __ldcg(R.at(c0 - b + i, c0 + k)) : 0.f;
          rd[u][j] = i < L && k < lc ? __ldcg(R.at(c0 + i, c0 + k)) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          if (chase && i < b && k < L && !(i == b - 1 && k == lc)) B[i * ld + k] = rb[u][j];
          if (i < L && k < lc) D[i * ld + k] = rd[u][j];
        }
    }
  }

  // Stage 1, early part: the loads, and for t >= 1 the previous u's
  // deferred left-apply: column sums per warp in row order, then in warp
  // order (the last column's without B's last element), and the update of
  // every column but the last.
  __device__ void early(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    c0 = s + 1 + t * b;
    L = min(b, n - c0);
    const int lc = L - 1;
    float* B = blockB(dyn);
    if (t == 0)
      for (int k = threadIdx.x; k < lc; k += NTH) sh.x[k] = __ldcg(R.at(s, c0 + k));
    fetch(B, B + b * ld, ld, t > 0);
    __syncthreads();
    if (t == 0) return;
    float acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= b) continue;
      const float ui = sh.up[i];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L && !(i == b - 1 && k == lc)) acc[j] = fmaf(ui, B[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < L; k += NTH) {
      float w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w += sh.part[q][k];
      sh.w[k] = w;
    }
    __syncthreads();
    float wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) wj[j] = lane + 32 * j < lc ? sh.w[lane + 32 * j] : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= b) continue;
      const float f = __fmul_rn(tp, sh.up[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < lc) B[i * ld + k] = __fsub_rn(B[i * ld + k], __fmul_rn(f, wj[j]));
      }
    }
  }

  // Stage 1, the rest: the late element and D's last column; warp 0
  // finishes row 0 (or row s) and forms v from it; every warp finishes its
  // rows' last column and right-applies v, straight to the ribbon.
  __device__ void first(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1, lc = L - 1;
    float* B = blockB(dyn);
    float* D = B + b * ld;
    for (int i = threadIdx.x; i < lc; i += NTH) D[i * ld + lc] = __ldcg(R.at(c0 + i, c0 + lc));
    if (wp == 0) {
      const float xl = __ldcg(R.at(t > 0 ? c0 - 1 : s, c0 + lc));
      float x[J];
      if (t > 0) {
        const float wl = fmaf(sh.up[b - 1], xl, sh.w[lc]);
        if (lane == 0) {
          B[(b - 1) * ld + lc] = xl;
          sh.sc[0] = wl;
        }
        __syncwarp();
        const float f = __fmul_rn(tp, sh.up[0]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[j] = k < lc ? B[k] : k == lc ? __fsub_rn(B[lc], __fmul_rn(f, wl)) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[j] = k < lc ? sh.x[k] : k == lc ? xl : 0.f;
        }
      }
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= 1 && k < L) p = fmaf(x[j], x[j], p);
      }
      const Householder h(__shfl_sync(0xffffffffu, x[0], 0), warp_sum(p));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L) sh.v[k] = k == 0 ? 1.f : x[j] / h.vden;
        if (t == 0 && k < L) *R.at(s, c0 + k) = k == 0 ? h.beta : 0.f;
      }
      if (lane == 0) {
        sh.sc[1] = h.tau;
        sh.sc[2] = h.beta;
      }
    }
    __syncthreads();
    tv = sh.sc[1];
    if (t == 0) return;
    const float wl = sh.sc[0], beta = sh.sc[2];
    float vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : 0.f;
    for (int g0 = 0; g0 < U; g0 += RG) {
      float x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        const float f = i < b ? __fmul_rn(tp, sh.up[i]) : 0.f;
        p[r] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = i < b && k < L ? B[i * ld + k] : 0.f;
          if (k == lc) x[r][j] = __fsub_rn(x[r][j], __fmul_rn(f, wl));
          if (k < L) p[r] = fmaf(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= b) continue;
        const float f = __fmul_rn(tv, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k >= L) continue;
          const float y = i == 0 ? (k == 0 ? beta : 0.f) : __fsub_rn(x[r][j], __fmul_rn(f, vj[j]));
          *R.at(c0 - b + i, c0 + k) = y;
        }
      }
    }
  }

  // Row i of D: v's right-apply by the warp that owns the row, in shared
  // memory; its column-0 entry to x and, from row 1, its square into sq.
  // The rows [lo, hi) of this warp, RG at once.
  __device__ __forceinline__ void right_rows(float* D, int ld, int lo, int hi, Vectors& sh) {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    float vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : 0.f;
    for (int g0 = 0; g0 < U; g0 += RG) {
      float x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        const bool on = i >= lo && i < hi;
        p[r] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = on && k < L ? D[i * ld + k] : 0.f;
          if (k < L) p[r] = fmaf(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i < lo || i >= hi) continue;
        const float f = __fmul_rn(tv, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L) D[i * ld + k] = x[r][j] = __fsub_rn(x[r][j], __fmul_rn(f, vj[j]));
        }
        if (lane == 0) {
          sh.x[i] = x[r][0];
          if (i >= 1) sq = fmaf(x[r][0], x[r][0], sq);
        }
      }
    }
  }

  // Between the stages, once B is published: v's right-apply to D's rows
  // but the last.
  __device__ void mid(int, int, float* dyn) {
    sq = 0.f;
    right_rows(blockB(dyn) + b * (b | 1), b | 1, 0, L - 1, vectors());
  }

  // Stage 2: D's last row, u from column 0, its left-apply, then the packs.
  __device__ void second(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1, lc = L - 1;
    float* D = blockB(dyn) + b * ld;
    if (wp == lc % NW) {
      if (lane == 0) D[lc * ld + lc] = __ldcg(R.at(c0 + lc, c0 + lc));
      __syncwarp();
      right_rows(D, ld, lc, L, sh);
    }
    if (lane == 0) sh.red[wp] = sq;
    __syncthreads();
    const Householder h(sh.x[0], warps_sum(sh.red));
    // u's left-apply to D's columns 1.. : column sums per warp, then in
    // warp order
    float acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const float ui = i == 0 ? 1.f : sh.x[i] / h.vden;
      if (lane == 0) sh.u[i] = ui;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= 1 && k < L) acc[j] = fmaf(ui, D[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < L; k += NTH) {
      float w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w += sh.part[q][k];
      sh.w[k] = w;
    }
    __syncthreads();
    float zj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) zj[j] = lane + 32 * j < L ? sh.w[lane + 32 * j] : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const float f = __fmul_rn(h.tau, sh.u[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= L) continue;
        const float y = k == 0 ? (i == 0 ? h.beta : 0.f)
                               : __fsub_rn(D[i * ld + k], __fmul_rn(f, zj[j]));
        *R.at(c0 + i, c0 + k) = y;
      }
    }
    const size_t task = static_cast<size_t>(s) * T + t;
    for (int i = threadIdx.x; i < L; i += NTH) {
      Vv[task * b + i] = sh.v[i];
      Vu[task * b + i] = sh.u[i];
      sh.up[i] = sh.u[i];
    }
    if (threadIdx.x == 0) {
      tauv[task] = tv;
      tauu[task] = h.tau;
    }
    tp = h.tau;
  }
};

template <int J>
cudaError_t run(float* rib, int n, int b, float* Vu, float* tauu, float* Vv, float* tauv,
                float* scratch, int max_ctas, unsigned* cnt, cudaStream_t st) {
  Tb2bd<J> task{};
  task.R = Ribbon{rib, 4LL * b - 1, 2 * b - 1};
  task.n = n;
  task.b = b;
  task.T = (n - 2) / b + 1;
  task.Vu = Vu;
  task.tauu = tauu;
  task.Vv = Vv;
  task.tauv = tauv;
  task.scratch = scratch;
  const size_t smem =
      J * 32 <= SMEM_BMAX ? static_cast<size_t>(2) * b * (b | 1) * sizeof(float) : 0;
  return slate::chase::launch(task, cnt, smem, max_ctas, st);
}

}  // namespace

// rib: the ribbon, n (4b) floats, updated in place. Vu, Vv: [n-1, T, b] and
// tauu, tauv: [n-1, T], T = (n-2)/b + 1, zeroed by the caller: the U-side and
// V-side packs. scratch: 2 b (b|1) floats per CTA for b > 128, max_ctas CTAs
// at most. cnt: 2 (n-1) counters, zeroed by the caller for every call.
// Returns a CUDA error code (0 on success).
extern "C" int slate_tb2bd_f32(float* rib, int n, int b, float* Vu, float* tauu, float* Vv,
                               float* tauv, float* scratch, int max_ctas, unsigned* cnt,
                               void* stream) {
  if (n < 2 || b < 1 || b > BMAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      b <= SMEM_BMAX ? run<4>(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, st)
                     : run<8>(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
