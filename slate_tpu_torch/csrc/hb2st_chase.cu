// The Hermitian band -> real tridiagonal bulge chase (K8):
//   slate_hb2st_f32, slate_hb2st_f64, slate_hb2st_c64, slate_hb2st_c128
//
// One template over the element type (chase_flow.cuh's scalars): float,
// double, complex<float>, complex<double>. The JAX package runs the three
// types beside float32 through its XLA wave (band_bulge_wave.py), not a
// Pallas kernel; here they are the float32 kernel's instantiations.
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
//     out (__fmul_rn, __fadd_rn) as its torch ops round. In complex the
//     left-apply sums conj(v) B, the right-apply subtracts conj(tau) (B v)
//     conj(v)^T, and D's update is y = conj(tau) D v, w = y - (tau / 2)
//     (v^H y) v, D -= v w^H + w v^H; a read of D's upper half is the
//     conjugate of its mirror.
// Measured (PERF.md section 6): the critical path is the task's period in its
// CTA plus its stage-1 tail, and the loads of the early part lead the
// period.
// The blocks live in shared memory while their bytes are within
// SMEM_BLOCK_BYTES (float bands up to 143, double and complex<float> up to
// 101, complex<double> up to 71) and in the global scratch the caller
// passes (two b x (b | 1) blocks per CTA) up to 256; the vectors always in
// shared memory. larfg is chase_flow.cuh's Householder, the twin's.

#include <cuda_runtime.h>

#include "chase_flow.cuh"

namespace {

using namespace slate::chase;

constexpr int BMAX = 256;  // widest band

// J column slots a lane (b <= 32 J): J = 4 up to band 128, J = 8 above.
template <class T, int J>
struct Hb2st {
  using S = real_t<T>;
  static constexpr int WD = sizeof(T) / 4;  // 32-bit words an element
  static constexpr int U = J * 2;           // row slots a warp: rows w + NW u, u < U
  // rows a warp loads in one batch, and reduces at once (fewer for wider T)
  static constexpr int UB = 16 / (J * WD) > 0 ? 16 / (J * WD) : 1;
  static constexpr int RG = 32 / (J * WD) > 0 ? 32 / (J * WD) : 1;
  static constexpr int BV = 32 * J;
  struct Vectors {
    T x[BV];   // column 0 of the bulge, the reflector's source
    T v[BV];   // the task's reflector
    T vp[BV];  // the previous task's
    T y[BV];   // left-apply column sums, then conj(tau) D v
    T part[NW][BV];
    T red[NW];
  };
  Ribbon<T> R;
  int n, b, T_;
  T* V;
  T* tau;
  T* scratch;  // null: the blocks in shared memory after the vectors
  // a thread's state from one stage or task to the next
  int i0, L;
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

  // Rows [0, rows) of B (t >= 1, from column j0) and of D's lower
  // triangle, loaded into registers in batches of UB rows a warp whose
  // loads are all in flight at once, then stored: B as it is, D into both
  // triangles (the upper one conjugated).
  __device__ __forceinline__ void fetch(T* B, T* D, int ld, int j0, bool chase, int rows) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    for (int u0 = 0; u0 < U; u0 += UB) {
      T rb[UB][J], rd[UB][J];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          rb[u][j] = chase && i < rows && k < b ? ldcg(R.at(i0 + i, j0 + k)) : T{};
          rd[u][j] = i < rows && k <= i ? ldcg(R.at(i0 + i, i0 + k)) : T{};
        }
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = wp + NW * (u0 + u), k = lane + 32 * j;
          if (chase && i < rows && k < b) B[i * ld + k] = rb[u][j];
          if (i < rows && k <= i) {
            D[i * ld + k] = rd[u][j];
            D[k * ld + i] = conj(rd[u][j]);
          }
        }
    }
  }

  // Row i of the bulge: the previous reflector's deferred right-apply, by
  // the warp that owns the row; its column-0 entry to x.
  __device__ __forceinline__ void right_row(T* B, int ld, int i, Vectors& sh) const {
    const int lane = threadIdx.x & 31;
    T p{};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) p = fma_(B[i * ld + k], sh.vp[k], p);
    }
    const T f = mul(conj(tp), warp_sum(p));
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) B[i * ld + k] = sub(B[i * ld + k], mul(f, conj(sh.vp[k])));
    }
    __syncwarp();
    if (lane == 0) sh.x[i] = B[i * ld];
  }

  // Stage 1, early part: every row of B (or column s) and D but the last,
  // which (s - 1, t + 1) may still write, loaded and right-applied; the
  // squares of column 0 summed per warp in row order. A warp takes RG of
  // its rows at once, so their loads and reductions overlap.
  __device__ void early(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    i0 = s + 1 + t * b;
    L = min(b, n - i0);
    const int lr = L - 1;
    T* B = blockB(dyn);
    if (t == 0)
      for (int i = threadIdx.x; i < lr; i += NTH) sh.x[i] = ldcg(R.at(i0 + i, s));
    fetch(B, B + b * ld, ld, i0 - b, t > 0, lr);
    __syncthreads();
    sq = S(0);
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = wp + NW * u;
        if (lane == 0 && i >= 1 && i < lr) sq = abs2_add(sh.x[i], sq);
      }
      return;
    }
    T vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < b ? sh.vp[lane + 32 * j] : T{};
    const T ctp = conj(tp);
    for (int g0 = 0; g0 < U; g0 += RG) {
      T x[RG][J], p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        p[r] = T{};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          x[r][j] = i < lr && k < b ? B[i * ld + k] : T{};
          if (k < b) p[r] = fma_(x[r][j], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= lr) continue;
        const T f = mul(ctp, p[r]);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < b) B[i * ld + k] = x[r][j] = sub(x[r][j], mul(f, conj(vj[j])));
        }
        if (lane == 0) {
          sh.x[i] = x[r][0];
          if (i >= 1) sq = abs2_add(x[r][0], sq);
        }
      }
    }
  }

  // Stage 1, the rest: the last row (by the warp that owns it, last in its
  // row order), larfg, the left-apply, and the bulge (or column s) stored.
  __device__ void first(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    const int j0 = i0 - b, il = L - 1;
    T* B = blockB(dyn);
    T* D = B + b * ld;
    if (wp == il % NW) {
      T rb[J], rd[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        rb[j] = t > 0 && k < b ? ldcg(R.at(i0 + il, j0 + k)) : T{};
        rd[j] = k < il ? ldcg(R.at(i0 + il, i0 + k)) : T{};
      }
      const T xl = t == 0 && lane == 0 ? ldcg(R.at(i0 + il, s)) : T{};
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (t > 0 && k < b) B[il * ld + k] = rb[j];
        if (k < il) {
          D[il * ld + k] = rd[j];
          D[k * ld + il] = conj(rd[j]);
        }
      }
      if (t == 0 && lane == 0) sh.x[il] = xl;
      __syncwarp();
      if (t > 0) right_row(B, ld, il, sh);
      if (lane == 0 && il >= 1) sq = abs2_add(sh.x[il], sq);
    }
    if (lane == 0) sh.red[wp] = of_real<T>(sq);
    __syncthreads();

    // larfg, every thread alike: the partial sums in warp order
    const S xn = re(warps_sum(sh.red));
    const Householder<T> h(sh.x[0], xn, rescue_norm(sh.x[0], xn, sh.x, L));
    tv = h.tau;

    if (t == 0) {
      for (int i = threadIdx.x; i < L; i += NTH) {
        sh.v[i] = i == 0 ? of_real<T>(S(1)) : quot(sh.x[i], h.vden);
        *R.at(i0 + i, s) = i == 0 ? of_real<T>(h.beta) : T{};
      }
      return;
    }
    // left-apply to B's columns 1.. : column sums of conj(v) B per warp,
    // then in warp order
    T acc[J] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const T vi = i == 0 ? of_real<T>(S(1)) : quot(sh.x[i], h.vden);
      if (lane == 0) sh.v[i] = vi;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < b) acc[j] = fmac(vi, B[i * ld + k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < b) sh.part[wp][k] = acc[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < b; k += NTH) {
      T w = sh.part[0][k];
      for (int q = 1; q < NW; ++q) w = add(w, sh.part[q][k]);
      sh.y[k] = w;
    }
    __syncthreads();
    T wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) wj[j] = lane + 32 * j < b ? sh.y[lane + 32 * j] : T{};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const T f = mul(tv, sh.v[i]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k >= b) continue;
        const T x = k == 0 ? (i == 0 ? of_real<T>(h.beta) : T{})
                           : sub(B[i * ld + k], mul(f, wj[j]));
        *R.at(i0 + i, j0 + k) = x;
      }
    }
  }

  // Nothing between the stages: D's update needs its last diagonal element.
  __device__ __forceinline__ void mid(int, int, char*) {}

  // Stage 2: D <- H D H^H on its lower triangle, then V and tau.
  __device__ void second(int s, int t, char* dyn) {
    Vectors& sh = vectors(dyn);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, ld = b | 1;
    T* D = blockB(dyn) + b * ld;
    if (threadIdx.x == 0) D[(L - 1) * ld + L - 1] = ldcg(R.at(i0 + L - 1, i0 + L - 1));
    __syncthreads();
    // y = conj(tau) D v, one warp a row, RG rows at once; v^H y by warp
    // partials in row order
    T c{}, vj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) vj[j] = lane + 32 * j < L ? sh.v[lane + 32 * j] : T{};
    const T ctv = conj(tv);
    for (int g0 = 0; g0 < U; g0 += RG) {
      T p[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        p[r] = T{};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (i < L && k < L) p[r] = fma_(D[i * ld + k], vj[j], p[r]);
        }
      }
      warp_sums(p);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int i = wp + NW * (g0 + r);
        if (i >= L) continue;
        const T yi = mul(ctv, p[r]);
        if (lane == 0) {
          sh.y[i] = yi;
          c = fmac(sh.v[i], yi, c);
        }
      }
    }
    if (lane == 0) sh.red[wp] = c;
    __syncthreads();
    const T al = mul(half_neg(tv), warps_sum(sh.red));
    // D -= v w^H + w v^H, w = y + al v, on the lower triangle, stored
    T wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      wj[j] = k < L ? add(sh.y[k], mul(al, vj[j])) : T{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = wp + NW * u;
      if (i >= L) continue;
      const T vi = sh.v[i], wi = add(sh.y[i], mul(al, vi));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k > i) continue;
        const T r2 = add(mul(vi, conj(wj[j])), mul(wi, conj(vj[j])));
        *R.at(i0 + i, i0 + k) = sub(D[i * ld + k], r2);
      }
    }
    const size_t task = static_cast<size_t>(s) * T_ + t;
    for (int i = threadIdx.x; i < L; i += NTH) {
      V[task * b + i] = sh.v[i];
      sh.vp[i] = sh.v[i];
    }
    if (threadIdx.x == 0) tau[task] = tv;
    tp = tv;
  }

  // -tau / 2, exact
  __device__ __forceinline__ static T half_neg(T a) {
    if constexpr (is_cx<T>) return T{S(-0.5) * a.re, S(-0.5) * a.im};
    else return S(-0.5) * a;
  }
};

template <class T, int J>
cudaError_t run(T* rib, int n, int b, T* V, T* tau, T* scratch, int max_ctas, unsigned* cnt,
                cudaStream_t st) {
  using Task = Hb2st<T, J>;
  Task task{};
  task.R = Ribbon<T>{rib, 4LL * b - 1, 2 * b - 1};
  task.n = n;
  task.b = b;
  task.T_ = (n - 2) / b + 1;
  task.V = V;
  task.tau = tau;
  const bool in_smem = scratch_elems(b, sizeof(T)) == 0;
  task.scratch = in_smem ? nullptr : scratch;
  const size_t blocks = static_cast<size_t>(2) * b * (b | 1) * sizeof(T);
  const size_t smem = sizeof(typename Task::Vectors) + (in_smem ? blocks : 0);
  return launch(task, cnt, smem, max_ctas, st);
}

template <class T>
int entry(T* rib, int n, int b, T* V, T* tau, T* scratch, int max_ctas, unsigned* cnt,
          void* stream) {
  if (n < 2 || b < 1 || b > BMAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = b <= 128 ? run<T, 4>(rib, n, b, V, tau, scratch, max_ctas, cnt, st)
                                 : run<T, 8>(rib, n, b, V, tau, scratch, max_ctas, cnt, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Elements of scratch one CTA needs at band b for elements of `item` bytes
// (0: the blocks go to shared memory); the wrapper sizes scratch by it.
extern "C" int slate_hb2st_scratch(int b, int item) {
  return scratch_elems(b, static_cast<size_t>(item));
}

// rib: the ribbon, n (4b) elements, updated in place (its lower triangle;
// a Hermitian band's diagonal real). V: [n-1, T, b] and tau: [n-1, T],
// T = (n-2)/b + 1, zeroed by the caller. scratch: slate_hb2st_scratch(b,
// sizeof(T)) elements per CTA, max_ctas CTAs at most.
// cnt: 2 (n-1) counters, zeroed by the caller for every call. Returns a
// CUDA error code (0 on success). The complex entries take interleaved
// (re, im) pairs, torch's complex64 and complex128.
extern "C" int slate_hb2st_f32(float* rib, int n, int b, float* V, float* tau, float* scratch,
                               int max_ctas, unsigned* cnt, void* stream) {
  return entry(rib, n, b, V, tau, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_hb2st_f64(double* rib, int n, int b, double* V, double* tau,
                               double* scratch, int max_ctas, unsigned* cnt, void* stream) {
  return entry(rib, n, b, V, tau, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_hb2st_c64(Cx<float>* rib, int n, int b, Cx<float>* V, Cx<float>* tau,
                               Cx<float>* scratch, int max_ctas, unsigned* cnt, void* stream) {
  return entry(rib, n, b, V, tau, scratch, max_ctas, cnt, stream);
}
extern "C" int slate_hb2st_c128(Cx<double>* rib, int n, int b, Cx<double>* V, Cx<double>* tau,
                                Cx<double>* scratch, int max_ctas, unsigned* cnt, void* stream) {
  return entry(rib, n, b, V, tau, scratch, max_ctas, cnt, stream);
}
