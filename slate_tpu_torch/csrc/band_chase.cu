// The upper band -> real upper bidiagonal bulge chase (K9):
//   slate_tb2bd_f32, slate_tb2bd_f64, slate_tb2bd_c64, slate_tb2bd_c128
//
// One template over the element type (chase_flow.cuh's scalars), as K8.
// The JAX package runs double and complex through its XLA wave
// (band_bulge_wave_bd.py), not a Pallas kernel. In complex the V-side
// reflector comes from the conjugated row (larfg of conj(B[0, :])) and is
// right-applied as B <- B (I - conj(tau) v v^H); the U-side reflector
// left-applies as (I - tau u u^H) B with column sums of conj(u) B. The
// column-0 phase (twin :239-249) is the wrapper's, before the launch.
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
// The blocks live in shared memory while their bytes are within
// SMEM_BLOCK_BYTES and in the global scratch the caller passes (two
// b x (b | 1) blocks per CTA) up to 256, as K8's. larfg is chase_flow.cuh's
// Householder, the twin's.

#include <cuda_runtime.h>

#include "chase_flow.cuh"

namespace {

using namespace slate::chase;

constexpr int BMAX = 256;  // widest band

// J column slots a lane (b <= 32 J): J = 4 up to band 128, J = 8 above.
template <class T, int J>
struct Tb2bd {
  using S = real_t<T>;
  static constexpr int WD = sizeof(T) / 4;  // 32-bit words an element
  static constexpr int U = J * 2;           // row slots a warp: rows w + NW u, u < U
  // rows a warp loads in one batch, and reduces at once (fewer for wider T)
  static constexpr int UB = 16 / (J * WD) > 0 ? 16 / (J * WD) : 1;
  static constexpr int RG = 32 / (J * WD) > 0 ? 32 / (J * WD) : 1;
  static constexpr int BV = 32 * J;
  struct Vectors {
    T x[BV];   // row s (t = 0), then D's column 0 after the right-apply
    T v[BV];   // the task's V-side reflector
    T u[BV];   // the task's U-side reflector
    T up[BV];  // the previous task's
    T w[BV];   // column sums: the previous u's left-apply, then u's
    T part[NW][BV];
    T red[NW];
    T sc[3];   // the last column's sum, tau_v, beta_v
  };
  Ribbon<T> R;
  int n, b, T_;
  T* Vu;
  T* tauu;
  T* Vv;
  T* tauv;
  T* scratch;  // null: the blocks in shared memory after the vectors
  // a thread's state from one stage or task to the next
  int c0, L;
  T tv, tp;
  S sq;

  __device__ __forceinline__ static Vectors& vectors(char* dyn) {
    return *reinterpret_cast<Vectors*>(dyn);
  }
  // Whether every band this J takes keeps its blocks in shared memory
  // (float with J = 4, bands up to 128): then blockB is a constant and no
  // select on scratch sits in the task's loops (a select there took K9
  // from 166 to 182 ms at n = 8192, band 128, on an H100).
  static constexpr bool SMEM_ALWAYS =
      static_cast<size_t>(2) * BV * (BV + 1) * sizeof(T) <= SMEM_BLOCK_BYTES;
  __device__ __forceinline__ T* blockB(char* dyn) const {
    const int ld = b | 1;
    if (SMEM_ALWAYS || !scratch) return reinterpret_cast<T*>(dyn + sizeof(Vectors));
    return scratch + static_cast<size_t>(blockIdx.x) * 2 * b * ld;
  }

  // B's rows (t >= 1) but its last element and D's rows but their last
  // column, loaded into registers in batches of UB rows a warp whose loads
  // are all in flight at once, then stored.
  __device__ __forceinline__ void fetch(T* B, T* D, int ld, bool chase) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, lc = L - 1;
    for (int u0 = 0; u0 < U; u0 += UB) {
      T rb[UB][J], rd[UB][J];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          const bool inb = chase && i < b && k < L && !(i == b - 1 && k == lc);
          rb[u][j] = inb ? ldcg(R.at(c0 - b + i, c0 + k)) : T{};
          rd[u][j] = i < L && k < lc ? ldcg(R.at(c0 + i, c0 + k)) : T{};
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
  // deferred left-apply: column sums of conj(u) B per warp in row order,
  // then in warp order (the last column's without B's last element), and
  // the update of every column but the last.
  __device__ void early(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    c0 = s + 1 + t * b;
    L = min(b, n - c0);
    const int lc = L - 1;
    T* B = blockB(dyn);
    if (t == 0)
      for (int k = threadIdx.x; k < lc; k += NTH) sh.x[k] = ldcg(R.at(s, c0 + k));
    fetch(B, B + b * ld, ld, t > 0);
    __syncthreads();
    if (t == 0) return;
    T acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= b) continue;
      const T ui = sh.up[i];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L && !(i == b - 1 && k == lc)) acc[j] = fmac(ui, B[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < L; k += NTH) {
      T w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w = add(w, sh.part[q][k]);
      sh.w[k] = w;
    }
    __syncthreads();
    T wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) wj[j] = lane + 32 * j < lc ? sh.w[lane + 32 * j] : T{};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= b) continue;
      const T f = mul(tp, sh.up[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < lc) B[i * ld + k] = sub(B[i * ld + k], mul(f, wj[j]));
      }
    }
  }

  // Stage 1, the rest: the late element and D's last column; warp 0
  // finishes row 0 (or row s) and forms v from its conjugate; every warp
  // finishes its rows' last column and right-applies v, straight to the
  // ribbon.
  __device__ void first(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1, lc = L - 1;
    T* B = blockB(dyn);
    T* D = B + b * ld;
    for (int i = threadIdx.x; i < lc; i += NTH) D[i * ld + lc] = ldcg(R.at(c0 + i, c0 + lc));
    if (wp == 0) {
      const T xl = ldcg(R.at(t > 0 ? c0 - 1 : s, c0 + lc));
      T x[J];
      if (t > 0) {
        const T wl = fmac(sh.up[b - 1], xl, sh.w[lc]);
        if (lane == 0) {
          B[(b - 1) * ld + lc] = xl;
          sh.sc[0] = wl;
        }
        __syncwarp();
        const T f = mul(tp, sh.up[0]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[j] = k < lc ? B[k] : k == lc ? sub(B[lc], mul(f, wl)) : T{};
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[j] = k < lc ? sh.x[k] : k == lc ? xl : T{};
        }
      }
      S p = S(0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= 1 && k < L) p = abs2_add(x[j], p);
      }
      const T alpha = conj(shfl(x[0], 0));
      const S xn = warp_sum(p);
      const Householder<T> h(alpha, xn, warp_rescue_norm(alpha, xn, x, L));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L) sh.v[k] = k == 0 ? of_real<T>(S(1)) : quot(conj(x[j]), h.vden);
        if (t == 0 && k < L) *R.at(s, c0 + k) = k == 0 ? of_real<T>(h.beta) : T{};
      }
      if (lane == 0) {
        sh.sc[1] = h.tau;
        sh.sc[2] = of_real<T>(h.beta);
      }
    }
    __syncthreads();
    tv = sh.sc[1];
    if (t == 0) return;
    const T wl = sh.sc[0], beta = sh.sc[2], ctv = conj(tv);
    T vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : T{};
    for (int g0 = 0; g0 < U; g0 += RG) {
      T x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        const T f = i < b ? mul(tp, sh.up[i]) : T{};
        p[r] = T{};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = i < b && k < L ? B[i * ld + k] : T{};
          if (k == lc) x[r][j] = sub(x[r][j], mul(f, wl));
          if (k < L) p[r] = fma_(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= b) continue;
        const T f = mul(ctv, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k >= L) continue;
          const T y = i == 0 ? (k == 0 ? beta : T{}) : sub(x[r][j], mul(f, conj(vj[j])));
          *R.at(c0 - b + i, c0 + k) = y;
        }
      }
    }
  }

  // Row i of D: v's right-apply by the warp that owns the row, in shared
  // memory; its column-0 entry to x and, from row 1, its squared modulus
  // into sq. The rows [lo, hi) of this warp, RG at once.
  __device__ __forceinline__ void right_rows(T* D, int ld, int lo, int hi, Vectors& sh) {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    T vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : T{};
    const T ctv = conj(tv);
    for (int g0 = 0; g0 < U; g0 += RG) {
      T x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        const bool on = i >= lo && i < hi;
        p[r] = T{};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = on && k < L ? D[i * ld + k] : T{};
          if (k < L) p[r] = fma_(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i < lo || i >= hi) continue;
        const T f = mul(ctv, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L) D[i * ld + k] = x[r][j] = sub(x[r][j], mul(f, conj(vj[j])));
        }
        if (lane == 0) {
          sh.x[i] = x[r][0];
          if (i >= 1) sq = abs2_add(x[r][0], sq);
        }
      }
    }
  }

  // Between the stages, once B is published: v's right-apply to D's rows
  // but the last.
  __device__ void mid(int, int, char* dyn) {
    sq = S(0);
    right_rows(blockB(dyn) + b * (b | 1), b | 1, 0, L - 1, vectors(dyn));
  }

  // Stage 2: D's last row, u from column 0, its left-apply, then the packs.
  __device__ void second(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1, lc = L - 1;
    T* D = blockB(dyn) + b * ld;
    if (wp == lc % NW) {
      if (lane == 0) D[lc * ld + lc] = ldcg(R.at(c0 + lc, c0 + lc));
      __syncwarp();
      right_rows(D, ld, lc, L, sh);
    }
    if (lane == 0) sh.red[wp] = of_real<T>(sq);
    __syncthreads();
    const S xn = re(warps_sum(sh.red));
    const Householder<T> h(sh.x[0], xn, rescue_norm(sh.x[0], xn, sh.x, L));
    // u's left-apply to D's columns 1.. : column sums of conj(u) D per
    // warp, then in warp order
    T acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const T ui = i == 0 ? of_real<T>(S(1)) : quot(sh.x[i], h.vden);
      if (lane == 0) sh.u[i] = ui;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= 1 && k < L) acc[j] = fmac(ui, D[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < L; k += NTH) {
      T w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w = add(w, sh.part[q][k]);
      sh.w[k] = w;
    }
    __syncthreads();
    T zj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) zj[j] = lane + 32 * j < L ? sh.w[lane + 32 * j] : T{};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const T f = mul(h.tau, sh.u[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= L) continue;
        const T y = k == 0 ? (i == 0 ? of_real<T>(h.beta) : T{})
                           : sub(D[i * ld + k], mul(f, zj[j]));
        *R.at(c0 + i, c0 + k) = y;
      }
    }
    const size_t task = static_cast<size_t>(s) * T_ + t;
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

template <class T, int J>
cudaError_t run(T* rib, int n, int b, T* Vu, T* tauu, T* Vv, T* tauv, T* scratch, int max_ctas,
                unsigned* cnt, cudaStream_t st) {
  using Task = Tb2bd<T, J>;
  Task task{};
  task.R = Ribbon<T>{rib, 4LL * b - 1, 2 * b - 1};
  task.n = n;
  task.b = b;
  task.T_ = (n - 2) / b + 1;
  task.Vu = Vu;
  task.tauu = tauu;
  task.Vv = Vv;
  task.tauv = tauv;
  const bool in_smem = scratch_elems(b, sizeof(T)) == 0;
  task.scratch = in_smem ? nullptr : scratch;
  const size_t blocks = static_cast<size_t>(2) * b * (b | 1) * sizeof(T);
  const size_t smem = sizeof(typename Task::Vectors) + (in_smem ? blocks : 0);
  return launch(task, cnt, smem, max_ctas, st);
}

template <class T>
int entry(T* rib, int n, int b, T* Vu, T* tauu, T* Vv, T* tauv, T* scratch, int max_ctas,
          unsigned* cnt, void* stream) {
  if (n < 2 || b < 1 || b > BMAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      b <= 128 ? run<T, 4>(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, st)
               : run<T, 8>(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Elements of scratch one CTA needs at band b for elements of `item` bytes
// (0: the blocks go to shared memory); the wrapper sizes scratch by it.
extern "C" int slate_tb2bd_scratch(int b, int item) {
  return scratch_elems(b, static_cast<size_t>(item));
}

// rib: the ribbon, n (4b) elements, updated in place (its (0, 0) made real
// by the caller's column-0 phase). Vu, Vv: [n-1, T, b] and tauu, tauv:
// [n-1, T], T = (n-2)/b + 1, zeroed by the caller: the U-side and V-side
// packs. scratch: slate_tb2bd_scratch(b, sizeof(T)) elements per
// CTA, max_ctas CTAs at most. cnt: 2 (n-1) counters, zeroed
// by the caller for every call. Returns a CUDA error code (0 on success).
// The complex entries take interleaved (re, im) pairs.
extern "C" int slate_tb2bd_f32(float* rib, int n, int b, float* Vu, float* tauu, float* Vv,
                               float* tauv, float* scratch, int max_ctas, unsigned* cnt,
                               void* stream) {
  return entry(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_tb2bd_f64(double* rib, int n, int b, double* Vu, double* tauu, double* Vv,
                               double* tauv, double* scratch, int max_ctas, unsigned* cnt,
                               void* stream) {
  return entry(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_tb2bd_c64(Cx<float>* rib, int n, int b, Cx<float>* Vu, Cx<float>* tauu,
                               Cx<float>* Vv, Cx<float>* tauv, Cx<float>* scratch, int max_ctas,
                               unsigned* cnt, void* stream) {
  return entry(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_tb2bd_c128(Cx<double>* rib, int n, int b, Cx<double>* Vu, Cx<double>* tauu,
                                Cx<double>* Vv, Cx<double>* tauv, Cx<double>* scratch,
                                int max_ctas, unsigned* cnt, void* stream) {
  return entry(rib, n, b, Vu, tauu, Vv, tauv, scratch, max_ctas, cnt, stream);
}
