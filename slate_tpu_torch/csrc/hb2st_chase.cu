// The symmetric band -> tridiagonal bulge chase (K8), in FP32:
//   slate_hb2st_f32
//
// Replaces _hb2st_vmem_jit (slate_tpu/internal/band_wave_vmem.py:492) and
// computes the task DAG of the numpy twin (slate_tpu/internal/band_bulge.py,
// hebr task types): task (sweep s, chase t) applies the previous reflector
// of its sweep to its b x b block B (the bulge), generates a Householder
// reflector of length L <= b from B's column 0 (for t = 0 from column s),
// left-applies it to the rest of B and applies it on both sides of the
// diagonal block D = A[i0 : i0 + L, i0 : i0 + L], i0 = s + 1 + t b.
//
// Bound on an H100: latency. A sweep trails the one before it by about
// two tasks, so the critical path is ~2n dependent task parts; the flops
// (~16 b^2 a task, 1.0 ms at n = 8192, b = 128) and the bytes are far
// below it. Design, from the split of the design it replaces (one launch
// per wave; PERF.md section 6: block moves 23.5 of its 42.5 us a task,
// arithmetic 18.9, the launches 4% of the time):
//   * One cooperative launch for the whole chase (chase_flow.cuh): CTA x
//     takes the sweeps x, x + G, ...; a task waits on counters of the
//     sweep before it, only for what it reads: all but the last row of
//     its blocks once (s - 1, t) is done, the last row once (s - 1, t + 1)
//     has stored its bulge, D's last diagonal element once (s - 1, t + 1)
//     is done. So the loads and the right-apply of all other rows run
//     before the previous sweep's next task has finished.
//   * The loads of a part are in flight together: B's and D's lower
//     triangle's rows, 4 rows x 4 columns a thread a batch (L2 loads),
//     then stored to shared memory, D mirrored there; no run-time
//     division in any loop.
//   * Only the lower triangle is kept: B has no mirror store and D stores
//     its lower half (the ribbon's upper triangle is never read).
//   * One warp a row for every pass, reductions by warp shuffles in a
//     fixed order (a fixed butterfly, then the warps' partials summed in
//     warp order), so runs repeat bit for bit. B's right-apply is
//     row-local (no barrier); the left-apply sums column partials per
//     warp. D's two-sided update is one matvec and one symmetric rank-2
//     update, written straight to the ribbon:
//       y = tau D v;  w = y - (tau / 2) (v^T y) v;  D -= v w^T + w v^T.
//     band_bulge.hb2st computes the same form; the rounding is written
//     out (__fmul_rn, __fadd_rn) as its torch ops round.
// Measured (PERF.md section 6): the critical path is the task's period in its
// CTA plus its stage-1 tail, and the loads of the early part lead the
// period.
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
  float x[BMAX];      // column 0 of the bulge, the reflector's source
  float v[BMAX];      // the task's reflector
  float vp[BMAX];     // the previous task's
  float y[BMAX];      // left-apply column sums, then tau D v
  float part[NW][BMAX];
  float red[NW];
};

__device__ __forceinline__ Vectors& vectors() {
  __shared__ Vectors sh;
  return sh;
}

// J column slots a lane (b <= 32 J): K8 with its blocks in shared memory
// (J = 4) or in global scratch (J = 8).
template <int J>
struct Hb2st {
  static constexpr int U = J * 2;           // row slots a warp: rows w + NW u, u < U
  static constexpr int UB = 16 / J;         // rows a warp loads in one batch
  static constexpr int RG = 32 / J;         // rows a warp reduces at once
  Ribbon R;
  int n, b, T;
  float* V;
  float* tau;
  float* scratch;
  // a thread's state from one stage or task to the next
  int i0, L;
  float tv, tp, sq;

  __device__ __forceinline__ float* blockB(float* dyn) const {
    const int ld = b | 1;
    return J * 32 <= SMEM_BMAX ? dyn : scratch + static_cast<size_t>(blockIdx.x) * 2 * b * ld;
  }

  // Rows [0, rows) of B (t >= 1, from column j0) and of D's lower
  // triangle, loaded into registers in batches of UB rows a warp whose
  // loads are all in flight at once, then stored: B as it is, D into both
  // triangles.
  __device__ __forceinline__ void fetch(float* B, float* D, int ld, int j0, bool chase,
                                        int rows) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    for (int u0 = 0; u0 < U; u0 += UB) {
      float rb[UB][J], rd[UB][J];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          rb[u][j] = chase && i < rows && k < b ? __ldcg(R.at(i0 + i, j0 + k)) : 0.f;
          rd[u][j] = i < rows && k <= i ? __ldcg(R.at(i0 + i, i0 + k)) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          if (chase && i < rows && k < b) B[i * ld + k] = rb[u][j];
          if (i < rows && k <= i) {
            D[i * ld + k] = rd[u][j];
            D[k * ld + i] = rd[u][j];
          }
        }
    }
  }

  // Row i of the bulge: the previous reflector's deferred right-apply, by
  // the warp that owns the row; its column-0 entry to x.
  __device__ __forceinline__ void right_row(float* B, int ld, int i, Vectors& sh) const {
    const int lane = threadIdx.x & 31;
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) p = fmaf(B[i * ld + k], sh.vp[k], p);
    }
    const float f = __fmul_rn(tp, warp_sum(p));
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) B[i * ld + k] = __fsub_rn(B[i * ld + k], __fmul_rn(f, sh.vp[k]));
    }
    __syncwarp();
    if (lane == 0) sh.x[i] = B[i * ld];
  }

  // Stage 1, early part: every row of B (or column s) and D but the last,
  // which (s - 1, t + 1) may still write, loaded and right-applied; the
  // squares of column 0 summed per warp in row order. A warp takes RG of
  // its rows at once, so their loads and reductions overlap.
  __device__ void early(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    i0 = s + 1 + t * b;
    L = min(b, n - i0);
    const int lr = L - 1;
    float* B = blockB(dyn);
    if (t == 0)
      for (int i = threadIdx.x; i < lr; i += NTH) sh.x[i] = __ldcg(R.at(i0 + i, s));
    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
    sq = 0.f;
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = wp + NW * u;
        if (lane == 0 && i >= 1 && i < lr) sq = fmaf(sh.x[i], sh.x[i], sq);
      }
      return;
    }
    float vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < b ? sh.vp[lane + 32 * j] : 0.f;
    for (int g0 = 0; g0 < U; g0 += RG) {
      float x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        p[r] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = i < lr && k < b ? B[i * ld + k] : 0.f;
          if (k < b) p[r] = fmaf(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= lr) continue;
        const float f = __fmul_rn(tp, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < b) B[i * ld + k] = x[r][j] = __fsub_rn(x[r][j], __fmul_rn(f, vj[j]));
        }
        if (lane == 0) {
          sh.x[i] = x[r][0];
          if (i >= 1) sq = fmaf(x[r][0], x[r][0], sq);
        }
      }
    }
  }

  // Stage 1, the rest: the last row (by the warp that owns it, last in its
  // row order), larfg, the left-apply, and the bulge (or column s) stored.
  __device__ void first(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    const int j0 = i0 - b, il = L - 1;
    float* B = blockB(dyn);
    float* D = B + b * ld;
    if (wp == il % NW) {
      float rb[J], rd[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        rb[j] = t > 0 && k < b ? __ldcg(R.at(i0 + il, j0 + k)) : 0.f;
        rd[j] = k < il ? __ldcg(R.at(i0 + il, i0 + k)) : 0.f;
      }
      const float xl = t == 0 && lane == 0 ? __ldcg(R.at(i0 + il, s)) : 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (t > 0 && k < b) B[il * ld + k] = rb[j];
        if (k < il) {
          D[il * ld + k] = rd[j];
          D[k * ld + il] = rd[j];
        }
      }
      if (t == 0 && lane == 0) sh.x[il] = xl;
      __syncwarp();
      if (t > 0) right_row(B, ld, il, sh);
      if (lane == 0 && il >= 1) sq = fmaf(sh.x[il], sh.x[il], sq);
    }
    if (lane == 0) sh.red[wp] = sq;
    __syncthreads();

    // larfg, every thread alike: the partial sums in warp order
    const float alpha = sh.x[0], xn = warps_sum(sh.red);
    float beta = alpha, vden = 1.f;
    tv = 0.f;
    if (xn != 0.f) {
      const float sgn = alpha < 0.f ? -1.f : 1.f;
      beta = -sgn * sqrtf(alpha * alpha + xn);
      tv = (beta - alpha) / beta;
      vden = alpha - beta;
    }

    if (t == 0) {
      for (int i = threadIdx.x; i < L; i += NTH) {
        sh.v[i] = i == 0 ? 1.f : sh.x[i] / vden;
        *R.at(i0 + i, s) = i == 0 ? beta : 0.f;
      }
      return;
    }
    // left-apply to B's columns 1.. : column sums per warp, then in warp order
    float acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const float vi = i == 0 ? 1.f : sh.x[i] / vden;
      if (lane == 0) sh.v[i] = vi;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < b) acc[j] = fmaf(vi, B[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < b; k += NTH) {
      float w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w += sh.part[q][k];
      sh.y[k] = w;
    }
    __syncthreads();
    float wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) wj[j] = lane + 32 * j < b ? sh.y[lane + 32 * j] : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const float f = __fmul_rn(tv, sh.v[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= b) continue;
        const float x = k == 0 ? (i == 0 ? beta : 0.f)
                               : __fsub_rn(B[i * ld + k], __fmul_rn(f, wj[j]));
        *R.at(i0 + i, j0 + k) = x;
      }
    }
  }

  // Nothing between the stages: D's update needs its last diagonal element.
  __device__ __forceinline__ void mid(int, int, float*) {}

  // Stage 2: D <- H D H on its lower triangle, then V and tau.
  __device__ void second(int s, int t, float* dyn) {
    Vectors& sh = vectors();
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    float* D = blockB(dyn) + b * ld;
    if (threadIdx.x == 0) D[(L - 1) * ld + L - 1] = __ldcg(R.at(i0 + L - 1, i0 + L - 1));
    __syncthreads();
    // y = tau D v, one warp a row, RG rows at once; v^T y by warp partials
    // in row order
    float c = 0.f, vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : 0.f;
    for (int g0 = 0; g0 < U; g0 += RG) {
      float p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        p[r] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (i < L && k < L) p[r] = fmaf(D[i * ld + k], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= L) continue;
        const float yi = __fmul_rn(tv, p[r]);
        if (lane == 0) {
          sh.y[i] = yi;
          c = fmaf(sh.v[i], yi, c);
        }
      }
    }
    if (lane == 0) sh.red[wp] = c;
    __syncthreads();
    const float al = __fmul_rn(-0.5f * tv, warps_sum(sh.red));
    // D -= v w^T + w v^T, w = y + al v, on the lower triangle, stored
    float wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      wj[j] = k < L ? __fadd_rn(sh.y[k], __fmul_rn(al, vj[j])) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const float vi = sh.v[i], wi = __fadd_rn(sh.y[i], __fmul_rn(al, vi));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k > i) continue;
        const float r2 = __fadd_rn(__fmul_rn(vi, wj[j]), __fmul_rn(wi, vj[j]));
        *R.at(i0 + i, i0 + k) = __fsub_rn(D[i * ld + k], r2);
      }
    }
    const size_t task = static_cast<size_t>(s) * T + t;
    for (int i = threadIdx.x; i < L; i += NTH) {
      V[task * b + i] = sh.v[i];
      sh.vp[i] = sh.v[i];
    }
    if (threadIdx.x == 0) tau[task] = tv;
    tp = tv;
  }
};

template <int J>
cudaError_t run(float* rib, int n, int b, float* V, float* tau, float* scratch, int max_ctas,
                unsigned* cnt, cudaStream_t st) {
  Hb2st<J> task{};
  task.R = Ribbon{rib, 4LL * b - 1, 2 * b - 1};
  task.n = n;
  task.b = b;
  task.T = (n - 2) / b + 1;
  task.V = V;
  task.tau = tau;
  task.scratch = scratch;
  const size_t smem =
      J * 32 <= SMEM_BMAX ? static_cast<size_t>(2) * b * (b | 1) * sizeof(float) : 0;
  return slate::chase::launch(task, cnt, smem, max_ctas, st);
}

}  // namespace

// rib: the ribbon, n (4b) floats, updated in place (its lower triangle).
// V: [n-1, T, b] and tau: [n-1, T], T = (n-2)/b + 1, zeroed by the caller.
// scratch: 2 b (b|1) floats per CTA for b > 128, max_ctas CTAs at most.
// cnt: 2 (n-1) counters, zeroed by the caller for every call. Returns a
// CUDA error code (0 on success).
extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, void* stream) {
  if (n < 2 || b < 1 || b > BMAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = b <= SMEM_BMAX ? run<4>(rib, n, b, V, tau, scratch, max_ctas, cnt, st)
                                       : run<8>(rib, n, b, V, tau, scratch, max_ctas, cnt, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
