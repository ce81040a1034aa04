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
#pragma once

#include <cuda_runtime.h>

#include "dataflow.cuh"

namespace slate {
namespace chase {

constexpr int NTH = 512;  // threads per CTA
constexpr int NW = NTH / 32;

// element (r, c) of the band at p[r * ld + c + off], ld = 4b - 1, off = 2b - 1
struct Ribbon {
  float* p;
  long long ld;
  int off;
  __device__ __forceinline__ float* at(int r, int c) const {
    return p + static_cast<long long>(r) * ld + c + off;
  }
};

// The task bodies' reductions, in a fixed order so that runs repeat bit
// for bit: a butterfly within a warp, then the warps' partials in warp order.
__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
  return p;
}

// warp_sum of each of RG values, the butterflies interleaved
template <int RG>
__device__ __forceinline__ void warp_sums(float (&p)[RG]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
#pragma unroll
    for (int r = 0; r < RG; ++r) p[r] += __shfl_xor_sync(0xffffffffu, p[r], m);
}

// Sum of red[0 .. NW) in warp order.
__device__ __forceinline__ float warps_sum(const float* red) {
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s += red[w];
  return s;
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
// as above. cnt: 2 (n - 1) zeroed counters, stage[] then done[].
template <class Task>
__global__ void __launch_bounds__(NTH) chase_flow(const Task task0, unsigned* cnt) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
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
