// The persistent loop of a bulge chase, shared by K8 (hb2st_chase.cu, the
// band -> tridiagonal chase) and K9 (band_chase.cu, band -> bidiagonal):
// one cooperative launch runs the whole chase.
//
// The chase is the twin's task DAG (slate_tpu/internal/band_bulge.py):
// task (sweep s, chase t) works on the b x b blocks around row and column
// i0 = s + 1 + t b, and reads its own sweep's previous reflector. CTA x of
// a grid of G takes the sweeps x, x + G, x + 2G, ... in order, and each
// sweep's tasks t = 0, 1, ... in order, so a sweep's reflector chain never
// leaves its CTA. A task runs in two stages, each published by a counter
// of its sweep in device memory:
//   first   its bulge block B (for t = 0 the column or row s), which it
//           annihilates and stores: t + 1 in stage[s];
//   second  its diagonal block D, whose update it stores: t + 1 in done[s].
// Of what task (s, t) reads, sweep s - 1 writes last: most of B and D in
// (s - 1, t); a late part of them in (s - 1, t + 1)'s first stage (its B
// block: K8's last row of B and D, K9's last element of B and last column
// of D) and D's last diagonal element in (s - 1, t + 1)'s second. So the
// task waits in three places, each count capped at the length of sweep
// s - 1: done[s - 1] >= t + 1 before it loads all but the late parts
// (early, which also starts the arithmetic on them), stage[s - 1] >= t + 2
// before it loads the late part and goes on with stage 1 (first),
// done[s - 1] >= t + 2 before it reads that element (second). Between its
// stage-1 publish and the last wait it may go on with what it holds (mid).
// Its writes come after the same waits. tests/test_torch_band_chase_sched.py
// models the order, both chases' element sets and the waits on the host.
// A task waits only on an earlier sweep, whose CTA is co-resident
// (cooperative launch) and runs it before any later one: so no CTA waits on
// a CTA that cannot run, and a wait over WAIT_LIMIT_NS traps (a launch error
// for the caller) instead of hanging the card.
//
// The counters count from 0 in every launch: the caller zeroes them with
// each call, so no epoch is needed. A counter is published by a release
// store after a block barrier (every thread's stores first), read with an
// acquire load, and what other CTAs wrote is read through L2 (__ldcg).
//
// The element type T is float, double, or the complex Cx<float>, Cx<double>
// below (the layout of torch's complex64/complex128). Every product, sum and
// difference of the task bodies goes through the helpers here, each rounded
// once as written: for a real T they are the float32 kernels' own intrinsics
// (fmaf, __fmul_rn, __fadd_rn, __fsub_rn), so the float32 instantiation
// computes the bits it computed before the bodies were templated. A complex
// product is rounded part by part, (ar br - ai bi, ar bi + ai br), so the
// imaginary part of v conj(w) + w conj(v) is exactly zero and a Hermitian
// block's diagonal stays real. Reductions shuffle the real and imaginary
// parts in the same fixed order, so every type repeats its bits.
#pragma once

#include <cuda_runtime.h>

#include "dataflow.cuh"

namespace slate {
namespace chase {

constexpr int NTH = 512;  // threads per CTA
constexpr int NW = NTH / 32;
// Bytes of a task's two b x (b | 1) blocks that may go to shared memory
// (with the vectors beside them, under the 227 KB an H100 block can take):
// float bands up to 143, double and complex<float> up to 101,
// complex<double> up to 71. Wider bands use the caller's scratch.
constexpr size_t SMEM_BLOCK_BYTES = 160 * 1024;

// Elements of global scratch one CTA needs at band b for elements of
// `item` bytes: 0 while its two blocks fit SMEM_BLOCK_BYTES, else the two
// blocks. The entries' *_scratch queries return it, so the wrappers size
// the scratch by the kernel's own rule.
inline int scratch_elems(int b, size_t item) {
  const int e = 2 * b * (b | 1);
  return static_cast<size_t>(e) * item <= SMEM_BLOCK_BYTES ? 0 : e;
}

// ---------------------------------------------------------------------------
// scalars
// ---------------------------------------------------------------------------

template <class R>
struct alignas(2 * sizeof(R)) Cx {
  R re, im;
};

template <class T>
struct RealOf {
  using type = T;
};
template <class R>
struct RealOf<Cx<R>> {
  using type = R;
};
template <class T>
using real_t = typename RealOf<T>::type;
template <class T>
constexpr bool is_cx = false;
template <class R>
constexpr bool is_cx<Cx<R>> = true;

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double rfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float fabs_(float a) { return fabsf(a); }
__device__ __forceinline__ double fabs_(double a) { return fabs(a); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

template <class T>
__device__ __forceinline__ T of_real(real_t<T> r) {
  if constexpr (is_cx<T>) return T{r, real_t<T>(0)};
  else return r;
}
template <class T>
__device__ __forceinline__ real_t<T> re(T a) {
  if constexpr (is_cx<T>) return a.re;
  else return a;
}
template <class T>
__device__ __forceinline__ real_t<T> im(T a) {
  if constexpr (is_cx<T>) return a.im;
  else return real_t<T>(0);
}
template <class T>
__device__ __forceinline__ T conj(T a) {
  if constexpr (is_cx<T>) return T{a.re, -a.im};
  else return a;
}
// a b
template <class T>
__device__ __forceinline__ T mul(T a, T b) {
  if constexpr (is_cx<T>)
    return T{rsub(rmul(a.re, b.re), rmul(a.im, b.im)), radd(rmul(a.re, b.im), rmul(a.im, b.re))};
  else return rmul(a, b);
}
template <class T>
__device__ __forceinline__ T add(T a, T b) {
  if constexpr (is_cx<T>) return T{radd(a.re, b.re), radd(a.im, b.im)};
  else return radd(a, b);
}
template <class T>
__device__ __forceinline__ T sub(T a, T b) {
  if constexpr (is_cx<T>) return T{rsub(a.re, b.re), rsub(a.im, b.im)};
  else return rsub(a, b);
}
// a b + c
template <class T>
__device__ __forceinline__ T fma_(T a, T b, T c) {
  if constexpr (is_cx<T>)
    return T{rfma(a.re, b.re, rfma(-a.im, b.im, c.re)), rfma(a.re, b.im, rfma(a.im, b.re, c.im))};
  else return rfma(a, b, c);
}
// conj(a) b + c
template <class T>
__device__ __forceinline__ T fmac(T a, T b, T c) {
  if constexpr (is_cx<T>)
    return T{rfma(a.re, b.re, rfma(a.im, b.im, c.re)), rfma(a.re, b.im, rfma(-a.im, b.re, c.im))};
  else return rfma(a, b, c);
}
// s + |a|^2
template <class T>
__device__ __forceinline__ real_t<T> abs2_add(T a, real_t<T> s) {
  if constexpr (is_cx<T>) return rfma(a.im, a.im, rfma(a.re, a.re, s));
  else return rfma(a, a, s);
}
// a / d; a complex d is scaled by its largest part first, so a tiny d's
// squared modulus cannot underflow
template <class T>
__device__ __forceinline__ T quot(T a, T d) {
  if constexpr (is_cx<T>) {
    using S = real_t<T>;
    const S s = fmax_(fabs_(d.re), fabs_(d.im));
    const S dr = d.re / s, di = d.im / s;
    const S den = rmul(rfma(dr, dr, rmul(di, di)), s);
    return T{rfma(a.re, dr, rmul(a.im, di)) / den, rfma(a.im, dr, -rmul(a.re, di)) / den};
  } else {
    return a / d;
  }
}
// an element loaded through L2 (what other CTAs wrote)
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ Cx<float> ldcg(const Cx<float>* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
__device__ __forceinline__ Cx<double> ldcg(const Cx<double>* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}
template <class T>
__device__ __forceinline__ T shfl_xor(T v, int m) {
  if constexpr (is_cx<T>)
    return T{__shfl_xor_sync(0xffffffffu, v.re, m), __shfl_xor_sync(0xffffffffu, v.im, m)};
  else return __shfl_xor_sync(0xffffffffu, v, m);
}
template <class T>
__device__ __forceinline__ T shfl(T v, int lane) {
  if constexpr (is_cx<T>)
    return T{__shfl_sync(0xffffffffu, v.re, lane), __shfl_sync(0xffffffffu, v.im, lane)};
  else return __shfl_sync(0xffffffffu, v, lane);
}

// element (r, c) of the band at p[r * ld + c + off], ld = 4b - 1, off = 2b - 1
template <class T>
struct Ribbon {
  T* p;
  long long ld;
  int off;
  __device__ __forceinline__ T* at(int r, int c) const {
    return p + static_cast<long long>(r) * ld + c + off;
  }
};

// The task bodies' reductions, in a fixed order so that runs repeat bit
// for bit: a butterfly within a warp, then the warps' partials in warp order.
template <class T>
__device__ __forceinline__ T warp_sum(T p) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) p = add(p, shfl_xor(p, m));
  return p;
}

// warp_sum of each of RG values, the butterflies interleaved
template <int RG, class T>
__device__ __forceinline__ void warp_sums(T (&p)[RG]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
#pragma unroll
    for (int r = 0; r < RG; ++r) p[r] = add(p[r], shfl_xor(p[r], m));
}

// Sum of red[0 .. NW) in warp order.
template <class T>
__device__ __forceinline__ T warps_sum(const T* red) {
  T s = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s = add(s, red[w]);
  return s;
}

// larfg as the twin computes it (slate_tpu/internal/band_bulge.py:44-67),
// from alpha and ||x[1:]||^2: beta = -sign(Re alpha) sqrt(|alpha|^2 +
// ||x[1:]||^2) with sign(0) = +1, real; tau = (beta - conj(alpha)) / beta;
// v = x / (alpha - beta), v[0] = 1. No reflector (tau = 0, beta = alpha) when
// ||x[1:]|| = 0 and alpha is real; a complex alpha alone is a phase rotation.
// A complex larfg may take its norm from the caller (norm >= 0): see
// rescue_norm.
template <class T>
struct Householder {
  using S = real_t<T>;
  S beta;
  T tau, vden;
  __device__ __forceinline__ Householder(T alpha, S xn, S norm = S(-1)) {
    if constexpr (is_cx<T>) {
      beta = alpha.re;
      tau = T{S(0), S(0)};
      vden = T{S(1), S(0)};
      if (xn != S(0) || alpha.im != S(0)) {
        const S sgn = alpha.re < S(0) ? S(-1) : S(1);
        beta = -sgn * (norm >= S(0) ? norm
                                    : sqrt_(alpha.re * alpha.re + alpha.im * alpha.im + xn));
        tau = T{(beta - alpha.re) / beta, alpha.im / beta};
        vden = T{alpha.re - beta, alpha.im};
      }
    } else {
      beta = alpha;
      tau = S(0);
      vden = S(1);
      if (xn != S(0)) {
        const S sgn = alpha < S(0) ? S(-1) : S(1);
        beta = -sgn * sqrt_(alpha * alpha + xn);
        tau = (beta - alpha) / beta;
        vden = alpha - beta;
      }
    }
  }
};

// A complex reflector's alpha alone (a phase rotation) or a short x can be
// tiny, where |alpha|^2 + ||x[1:]||^2 loses its squares to underflow and
// beta would come out 0 (tau infinite) or inconsistent with x. Below
// TINY_NORM2 (2^-100 in float, 2^-900 in double: the squares lost there
// are below one rounding of the sum) the norm is taken again from x
// scaled by its largest part. Real types never take this path (a real x
// with ||x[1:]|| = 0 needs no reflector), so their bits are unchanged.
template <class S>
__device__ __forceinline__ S tiny_norm2() {
  return sizeof(S) == 4 ? S(0x1p-100) : S(0x1p-900);
}

// max(|Re a|, |Im a|), and a / s for a real s
template <class T>
__device__ __forceinline__ real_t<T> part_max(T a) {
  return fmax_(fabs_(re(a)), fabs_(im(a)));
}
template <class T>
__device__ __forceinline__ T scaled(T a, real_t<T> s) {
  if constexpr (is_cx<T>) return T{a.re / s, a.im / s};
  else return a / s;
}

// The norm for Householder: -1 (from alpha and xn), or for a complex
// larfg below tiny_norm2 ||x[0 .. L)|| from x scaled by its largest part;
// x in shared memory, every thread alike.
template <class T>
__device__ __forceinline__ real_t<T> rescue_norm(T alpha, real_t<T> xn, const T* x, int L) {
  using S = real_t<T>;
  if constexpr (is_cx<T>) {
    if (alpha.re * alpha.re + alpha.im * alpha.im + xn < tiny_norm2<S>()) {
      S sc = S(0), q = S(0);
      for (int i = 0; i < L; ++i) sc = fmax_(sc, part_max(x[i]));
      if (sc == S(0)) return S(0);
      for (int i = 0; i < L; ++i) q = abs2_add(scaled(x[i], sc), q);
      return sc * sqrt_(q);
    }
  }
  return S(-1);
}

// rescue_norm of an x held by one warp, element lane + 32 j in x[j]; every
// lane gets the same bits (xor butterflies).
template <int J, class T>
__device__ __forceinline__ real_t<T> warp_rescue_norm(T alpha, real_t<T> xn, const T (&x)[J],
                                                      int L) {
  using S = real_t<T>;
  if constexpr (is_cx<T>) {
    if (alpha.re * alpha.re + alpha.im * alpha.im + xn < tiny_norm2<S>()) {
      const int lane = threadIdx.x & 31;
      S sc = S(0), q = S(0);
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < L) sc = fmax_(sc, part_max(x[j]));
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) sc = fmax_(sc, __shfl_xor_sync(0xffffffffu, sc, m));
      if (sc == S(0)) return S(0);
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < L) q = abs2_add(scaled(x[j], sc), q);
      return sc * sqrt_(warp_sum(q));
    }
  }
  return S(-1);
}

__device__ __forceinline__ int sweep_tasks(int n, int b, int s) { return (n - 2 - s) / b + 1; }

// Thread 0 spins until f0 >= v0 and f1 >= v1 (f1 may be null); the block
// barrier then passes its acquire on to the CTA.
__device__ __forceinline__ void wait_counts(const unsigned* f0, unsigned v0, const unsigned* f1,
                                            unsigned v1) {
  if (threadIdx.x == 0) {
    const unsigned* fs[2] = {f0, f1};
    const unsigned vs[2] = {v0, v1};
    unsigned long long t0 = 0;
    for (int q = 0; q < 2; ++q)
      while (fs[q] && df::ld_acquire(fs[q]) < vs[q]) {
        __nanosleep(32);
        const unsigned long long t = df::now_ns();
        if (t0 == 0) t0 = t;
        if (t - t0 > df::WAIT_LIMIT_NS) __trap();
      }
  }
  __syncthreads();
}

// Every thread's stores so far become visible before the count does: the
// block barrier orders them before thread 0's release store (gpu scope,
// cumulative), as CUTLASS's semaphore releases.
__device__ __forceinline__ void publish(unsigned* f, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) df::st_release(f, v);
}

// The whole chase: sweeps blockIdx.x, + gridDim.x, ...; Task provides
// early(s, t, dyn), first(s, t, dyn), mid(s, t, dyn) and second(s, t, dyn)
// as above, dyn its dynamic shared memory. cnt: 2 (n - 1) zeroed counters,
// stage[] then done[].
template <class Task>
__global__ void __launch_bounds__(NTH) chase_flow(const Task task0, unsigned* cnt) {
  extern __shared__ float4 dyn4[];
  char* dyn = reinterpret_cast<char*>(dyn4);
  Task task = task0;  // carries a thread's state from one stage to the next
  const int n = task.n, b = task.b, S = n - 1;
  unsigned* stage = cnt;
  unsigned* done = cnt + S;
  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    const int ts = sweep_tasks(n, b, s);
    const int tp = s > 0 ? sweep_tasks(n, b, s - 1) : 0;
    for (int t = 0; t < ts; ++t) {
      if (s > 0) wait_counts(done + s - 1, min(t + 1, tp), nullptr, 0);
      task.early(s, t, dyn);
      if (s > 0) wait_counts(stage + s - 1, min(t + 2, tp), nullptr, 0);
      task.first(s, t, dyn);
      publish(stage + s, t + 1);
      task.mid(s, t, dyn);
      if (s > 0) wait_counts(done + s - 1, min(t + 2, tp), nullptr, 0);
      task.second(s, t, dyn);
      publish(done + s, t + 1);
    }
  }
}

// Launch chase_flow<Task> cooperatively on as many CTAs as are co-resident
// (at most max_ctas and one per sweep), with smem dynamic bytes; the
// caller checks cudaGetLastError after it.
template <class Task>
cudaError_t launch(const Task& task, unsigned* cnt, size_t smem, int max_ctas,
                   cudaStream_t stream) {
  auto kernel = chase_flow<Task>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTH, smem);
  if (e != cudaSuccess) return e;
  int G = per_sm * sms;
  G = G < max_ctas ? G : max_ctas;
  G = G < task.n - 1 ? G : task.n - 1;
  if (G < 1) return cudaErrorCooperativeLaunchTooLarge;
  Task arg = task;
  void* args[] = {&arg, &cnt};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(G), dim3(NTH), args,
                                     smem, stream);
}

}  // namespace chase
}  // namespace slate
