// Shared pieces of the dataflow tile kernels (K1 potrf_tile.cu, K2
// trsm_lower.cu, K3 trsm_left.cu, K7 lu_nopiv_tile.cu): one persistent
// cooperative grid whose CTAs take 64-wide tasks in a fixed order and wait
// for the tasks they read through a ready flag per task in global memory,
// the 64x64 FP32 operand tiles in shared memory with their products, and
// the inverse of a lower-triangular 64x64 block by recursive doubling.
//
// Flags carry an epoch: the caller keeps one flag buffer per stream and
// passes a new epoch to every launch, so a task is ready once its flag has
// reached this launch's epoch and no memset runs between launches. The
// signed difference orders a flag against the epoch; the caller zeroes
// the buffer and starts again at epoch 1 before the epoch reaches 2^30
// (kernels.py EPOCH_RESTART), so no flag is ever 2^31 behind.
#pragma once

#include <cuda_runtime.h>

namespace slate {
namespace df {

constexpr int BT = 64;        // task edge: a 64x64 tile of K1, a 64-row block of K3
constexpr int NTH = 256;      // threads per CTA
constexpr int PL = BT + 4;    // pitch of an operand tile: rows of float4, and a
                              // phase of 8 threads reading rows tx, tx+16, ...
                              // hits 8 distinct 16-byte bank groups
constexpr int WSCR = 1024;    // scratch floats of inv_lower (32 s at s = 32)
// Nanoseconds a wait may last before it is taken for a deadlock and the
// kernel traps (a launch error for the caller) rather than hanging the
// card; a healthy wait lasts microseconds.
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ULL;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ bool reached(const unsigned* f, unsigned epoch) {
  return static_cast<int>(ld_acquire(f) - epoch) >= 0;
}

// Thread 0 spins until both flags (f1 may be null) have reached `epoch`,
// then the block barrier passes its acquire on to the rest of the CTA.
// Data other CTAs published is then read with __ldcg (L2), never through a
// stale L1 line.
__device__ __forceinline__ void wait2(const unsigned* f0, const unsigned* f1,
                                      unsigned epoch) {
  if (threadIdx.x == 0) {
    const unsigned* fs[2] = {f0, f1};
    unsigned long long t0 = 0;
    for (int q = 0; q < 2; ++q)
      while (fs[q] && !reached(fs[q], epoch)) {
        __nanosleep(20);
        const unsigned long long t = now_ns();
        if (t0 == 0) t0 = t;
        if (t - t0 > WAIT_LIMIT_NS) __trap();
      }
  }
  __syncthreads();
}

// Every thread's stores so far become visible before the flag does.
__device__ __forceinline__ void publish(unsigned* f, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(f, epoch);
  }
}

// The 16 entries of a 64x64 tile that thread t moves: rows t/64 + 4q,
// column t%64.
constexpr int PER = BT * BT / NTH;

// v[q] = g[i * ld + k] for this thread's (i, k) with i < rows, k < cols,
// zero elsewhere: L2 loads (g may have been written by another CTA), all
// in flight at once.
__device__ __forceinline__ void fetch(float v[PER], const float* g, size_t ld, int rows,
                                      int cols) {
  const int i0 = threadIdx.x / BT, k = threadIdx.x % BT;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + q * (NTH / BT);
    v[q] = (i < rows && k < cols) ? __ldcg(g + i * ld + k) : 0.f;
  }
}

// s[i * ps + k] = v[q] for this thread's entries.
__device__ __forceinline__ void stash(float* s, int ps, const float v[PER]) {
  const int i0 = threadIdx.x / BT, k = threadIdx.x % BT;
#pragma unroll
  for (int q = 0; q < PER; ++q) s[(i0 + q * (NTH / BT)) * ps + k] = v[q];
}

// s = the rows x cols window of g, zero-padded to 64x64.
__device__ __forceinline__ void load_cg(float* s, int ps, const float* g, size_t ld,
                                        int rows, int cols) {
  float v[PER];
  fetch(v, g, ld, rows, cols);
  stash(s, ps, v);
}

// acc[r][c] += sum_k a[ty + 16r][k] * b[tx + 16c][k]  (A times B^T over 64 k),
// a and b of pitch PL, read as float4 along k.
__device__ __forceinline__ void prod_abt(const float* a, const float* b, float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < BT; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty + 16 * r) * PL + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * PL + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        s = fmaf(av[r].w, bv[c].w, s);
        acc[r][c] = s;
      }
  }
}

// One level of inv_lower at block size S = 2^LS: for every 2S-block
// [[A, 0], [C, D]] of the 64x64 inverse v whose S-blocks are inverted,
// W = C * A^-1, then the lower-left block -D^-1 * W. The 32 S elements of a
// level are spread over the threads, several a thread sharing one column,
// and every contraction runs over all S terms (the triangles' zeros add
// exact zeros), so the loops unroll and the products are independent.
template <int LS>
__device__ __forceinline__ void inv_level(const float* t, int pt, float* v, int pv,
                                          float* w_scr, int w) {
  constexpr int S = 1 << LS, NE = 32 << LS, PT = NE >= NTH ? NE / NTH : 1;
  const bool on = NE >= NTH || static_cast<int>(threadIdx.x) < NE;
  int bs[PT], rs[PT], c = 0;
#pragma unroll
  for (int u = 0; u < PT; ++u) {
    const int e = threadIdx.x + u * NTH;
    bs[u] = 2 * S * (e >> (2 * LS));
    rs[u] = (e >> LS) & (S - 1);
    c = e & (S - 1);
  }
  float acc[PT];
#pragma unroll
  for (int u = 0; u < PT; ++u) acc[u] = 0.f;
  if (on) {
#pragma unroll
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        const int p = bs[u], row = p + S + rs[u];
        const float cv = row < w ? t[row * pt + p + q] : 0.f;
        acc[u] = fmaf(cv, v[(p + q) * pv + p + c], acc[u]);
      }
#pragma unroll
    for (int u = 0; u < PT; ++u) w_scr[threadIdx.x + u * NTH] = acc[u];
  }
  __syncthreads();
  if (on) {
#pragma unroll
    for (int u = 0; u < PT; ++u) acc[u] = 0.f;
#pragma unroll
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        const int p = bs[u];
        const int blk = (threadIdx.x + u * NTH) >> (2 * LS);
        acc[u] = fmaf(v[(p + S + rs[u]) * pv + p + S + q], w_scr[(blk << (2 * LS)) + q * S + c],
                      acc[u]);
      }
#pragma unroll
    for (int u = 0; u < PT; ++u) v[(bs[u] + S + rs[u]) * pv + bs[u] + c] = -acc[u];
  }
  __syncthreads();
}

// Inverse of the lower-triangular block t (pitch pt; rows and columns
// >= w taken as the identity) into v (pitch pv, 64x64), by recursive
// doubling: v starts as the inverted diagonal, and at block size s = 1, 2,
// ..., 32 every 2s-block gets its lower-left inverse block from the two
// s-blocks already inverted (inv_level). Six levels of two barriered
// products each, so the dependent chain is ~2 * 63 FMAs, not the 2000 of a
// substitution. `unit` takes the diagonal as ones. Ends with a block
// barrier. w_scr holds WSCR floats.
__device__ __forceinline__ void inv_lower(const float* t, int pt, float* v, int pv,
                                          float* w_scr, int w, bool unit) {
  for (int idx = threadIdx.x; idx < BT * BT; idx += NTH) {
    const int i = idx / BT, c = idx % BT;
    float x = 0.f;
    if (i == c) x = (unit || i >= w) ? 1.f : 1.f / t[i * pt + i];
    v[i * pv + c] = x;
  }
  __syncthreads();
  inv_level<0>(t, pt, v, pv, w_scr, w);
  inv_level<1>(t, pt, v, pv, w_scr, w);
  inv_level<2>(t, pt, v, pv, w_scr, w);
  inv_level<3>(t, pt, v, pv, w_scr, w);
  inv_level<4>(t, pt, v, pv, w_scr, w);
  inv_level<5>(t, pt, v, pv, w_scr, w);
}

// Largest grid of `kernel` (NTH threads, `smem` dynamic bytes) that can be
// co-resident on the current device; sets the shared-memory limit first.
template <typename Kernel>
inline cudaError_t coresident(Kernel kernel, size_t smem, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTH, smem);
  *ctas = per_sm * sms;
  if (e == cudaSuccess && *ctas < 1) e = cudaErrorCooperativeLaunchTooLarge;
  return e;
}

}  // namespace df
}  // namespace slate
