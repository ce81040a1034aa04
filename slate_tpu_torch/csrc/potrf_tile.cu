// K1: lower Cholesky of one [nb, nb] FP32 tile (nb <= 1024), or of each
// tile of a [batch, nb, nb] stack, in place, upper triangles zeroed.
//
// Replaces potrf_tile_pallas (slate_tpu/internal/pallas_kernels.py), which
// keeps the whole tile in VMEM and walks it in 64-column blocks. On the
// H100 the work (nb^3 / 3 flops, 5 microseconds of the card's FP32 rate at
// nb = 1024) is not the bound: the chain of 16 dependent diagonal blocks
// is. Walking the blocks from a host loop puts three launches and a
// one-CTA diagonal factor with a serial inverse on that chain per block.
//
// Design: one cooperative launch, a left-looking tile algorithm driven by
// data. The tile stays in global memory (4 MB at nb = 1024, resident in
// L2). Its lower 64x64 tiles (i, k) are tasks, taken block column by block
// column in a fixed order by a grid no larger than what is co-resident
// (136 tasks at nb = 1024, so about one CTA each). Task (i, k) sums
// L[i, j] * L[k, j]^T over j < k, each product as soon as the ready flags
// of its two tiles show them; then
//   i == k: factors A[k, k] minus the sum in shared memory (16-column
//           panels, each by one warp in registers, with a block-wide
//           trailing update between them) and inverts the factor by
//           recursive doubling (dataflow.cuh) into a scratch slot;
//   i >  k: waits for that inverse and forms L[i, k] = (A[i, k] - sum) *
//           inv(L[k, k])^T as one product, and zeroes the mirrored upper tile.
// The chain per block column is then one diagonal task and one panel task,
// with no launch and no grid barrier on it; the trailing products of later
// columns overlap it. Math is FP32 FMAs on the CUDA cores (the precision
// policy pins tile factors to full FP32, so no TF32 tensor-core path). A
// non-positive pivot d gives d * rsqrt(d) = NaN (0 * inf for d = 0), which
// reaches the diagonal so the caller's finite guard reports the block.
//
// A stack (the batched drivers' diagonal blocks, which the JAX package
// factors with one vmapped Pallas call) is one launch as well: the
// persistent loop runs over batch * ntask tasks, instance-major, each
// member with its own ready flags and inverse slots. Every wait is then on
// a lower-numbered task of the same member, so the deadlock-freedom
// argument of dataflow.cuh holds unchanged, the members' chains overlap
// on the card, and a member's arithmetic (and a NaN from its pivots) is
// that of its own single-tile launch.

#include "dataflow.cuh"

namespace {

using namespace slate::df;

constexpr int PS = BT + 1;  // pitch of the diagonal block: column walks hit 32 banks

constexpr int CP = 16;       // panel width of the diagonal block's factor

// Columns p .. p+15 of the w x w block s (pitch PS), rows p .. w-1, factored
// right-looking by one warp in registers: lane l holds rows p+l and
// p+l+32, a column step is a shuffle of the pivot, r = rsqrt(pivot) (one
// MUFU op on the chain: the pivot is d * r, the column l = s[:, j] * r) and
// shuffles of l for the update. No block barrier inside the panel.
__device__ void chol_panel(float* s, int w, int p) {
  const int lane = threadIdx.x % 32, r0 = p + lane, r1 = p + lane + 32;
  float a0[CP], a1[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    a0[c] = (r0 < w && p + c < w) ? s[r0 * PS + p + c] : 0.f;
    a1[c] = (r1 < w && p + c < w) ? s[r1 * PS + p + c] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    if (p + j < w) {
      const float d = __shfl_sync(0xffffffffu, a0[j], j);
      const float rp = rsqrtf(d);
      const float l0 = a0[j] * rp, l1 = a1[j] * rp;
#pragma unroll
      for (int k = j + 1; k < CP; ++k) {
        const float lk = __shfl_sync(0xffffffffu, l0, k);
        a0[k] = fmaf(-l0, lk, a0[k]);
        a1[k] = fmaf(-l1, lk, a1[k]);
      }
      a0[j] = lane == j ? d * rp : l0;
      a1[j] = l1;
    }
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (r0 < w && p + c <= r0) s[r0 * PS + p + c] = a0[c];
    if (r1 < w && p + c < w) s[r1 * PS + p + c] = a1[c];
  }
}

// In-place lower Cholesky of the w x w block s (pitch PS) in 16-column
// panels: each panel by one warp (chol_panel), then the lower trailing
// block minus the panel's product, a 16-term dot an element over all
// threads. Eight block barriers in all. Ends with a block barrier.
__device__ void chol_block(float* s, int w) {
  for (int p = 0; p < w; p += CP) {
    if (threadIdx.x < 32) chol_panel(s, w, p);
    __syncthreads();
    const int e0 = p + CP, m = w - e0;
    for (int idx = threadIdx.x; idx < m * m; idx += NTH) {
      const int i = e0 + idx / m, k = e0 + idx % m;
      if (k > i) continue;
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < CP; ++q) dot = fmaf(s[i * PS + p + q], s[k * PS + p + q], dot);
      s[i * PS + k] -= dot;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTH)
dataflow_potrf_tile(float* a0, int nb, int batch, float* inv0, unsigned* flags0,
                    unsigned epoch) {
  extern __shared__ float4 smem4[];
  float* pa = reinterpret_cast<float*>(smem4);  // 64 x PL
  float* pb = pa + BT * PL;                      // 64 x PL
  float* sd = pb + BT * PL;                      // 64 x PS
  float* wscr = sd + BT * PS;                    // WSCR
  __shared__ bool s_next;
  const int nt = (nb + BT - 1) / BT, ntask = nt * (nt + 1) / 2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // task (i, k), i >= k, in block-column order
  auto task = [nt](int i, int k) { return k * nt - k * (k - 1) / 2 + (i - k); };

  const long long total = static_cast<long long>(batch) * ntask;
  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const int member = static_cast<int>(g / ntask), t = static_cast<int>(g % ntask);
    float* a = a0 + static_cast<size_t>(member) * nb * nb;
    float* inv = inv0 + static_cast<size_t>(member) * nt * BT * BT;
    unsigned* flags = flags0 + static_cast<size_t>(member) * ntask;
    int k = 0, i = t;
    while (i >= nt - k) {
      i -= nt - k;
      ++k;
    }
    i += k;
    const int r0 = i * BT, c0 = k * BT;
    const int hi = min(BT, nb - r0), wk = min(BT, nb - c0);
    float* tile = a + static_cast<size_t>(r0) * nb + c0;
    // the task's own tile of A, read before the chain reaches it
    float own[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = ty + 16 * r, kk = tx + 16 * c;
        own[r][c] = (ii < hi && kk < wk && (i != k || kk <= ii))
                        ? __ldcg(tile + static_cast<size_t>(ii) * nb + kk)
                        : 0.f;
      }

    // sum_j L[i, j] * L[k, j]^T; the tiles of step j + 1 are fetched
    // during step j's product when their flags are already up
    float acc[4][4] = {};
    float va[PER], vb[PER];
    const float* gi = a + static_cast<size_t>(r0) * nb;
    const float* gk = a + static_cast<size_t>(c0) * nb;
    bool have = false;
    for (int j = 0; j < k; ++j) {
      if (!have) {
        wait2(flags + task(i, j), i == k ? nullptr : flags + task(k, j), epoch);
        fetch(va, gi + j * BT, nb, hi, BT);
        if (i != k) fetch(vb, gk + j * BT, nb, wk, BT);
      }
      stash(pa, PL, va);
      if (i != k) stash(pb, PL, vb);
      if (threadIdx.x == 0)
        s_next = j + 1 < k && reached(flags + task(i, j + 1), epoch) &&
                 reached(flags + task(k, j + 1), epoch);
      __syncthreads();
      have = s_next;
      if (have) {
        fetch(va, gi + (j + 1) * BT, nb, hi, BT);
        if (i != k) fetch(vb, gk + (j + 1) * BT, nb, wk, BT);
      }
      prod_abt(pa, i == k ? pa : pb, acc);
      __syncthreads();
    }

    if (i == k) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = ty + 16 * r, kk = tx + 16 * c;
          sd[ii * PS + kk] = (ii < wk && kk <= ii) ? own[r][c] - acc[r][c] : 0.f;
        }
      __syncthreads();
      chol_block(sd, wk);
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH) {
        const int ii = idx / BT, kk = idx % BT;
        if (ii < wk && kk < wk)
          tile[static_cast<size_t>(ii) * nb + kk] = kk <= ii ? sd[ii * PS + kk] : 0.f;
      }
      inv_lower(sd, PS, pa, PL, wscr, wk, false);
      float* slot = inv + static_cast<size_t>(k) * BT * BT;
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH)
        slot[idx] = pa[(idx / BT) * PL + idx % BT];
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = ty + 16 * r, kk = tx + 16 * c;
          pa[ii * PL + kk] = (ii < hi && kk < wk) ? own[r][c] - acc[r][c] : 0.f;
        }
      wait2(flags + task(k, k), nullptr, epoch);
      load_cg(pb, PL, inv + static_cast<size_t>(k) * BT * BT, BT, BT, BT);
      __syncthreads();
      float out[4][4] = {};
      prod_abt(pa, pb, out);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = ty + 16 * r, kk = tx + 16 * c;
          if (ii < hi && kk < wk) tile[static_cast<size_t>(ii) * nb + kk] = out[r][c];
        }
      // the mirrored tile (k, i) lies in the upper triangle
      float* up = a + static_cast<size_t>(c0) * nb + r0;
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH) {
        const int ii = idx / BT, kk = idx % BT;
        if (ii < wk && kk < hi) up[static_cast<size_t>(ii) * nb + kk] = 0.f;
      }
    }
    publish(flags + t, epoch);
  }
}

}  // namespace

// a: batch [nb, nb] row-major FP32 tiles on the device, one after the
// other, each factored in place. inv: batch * ceil(nb / 64) * 64 * 64
// floats of scratch (each member's diagonal blocks' inverses). flags:
// batch * ceil(nb / 64) * (ceil(nb / 64) + 1) / 2 ready flags whose values
// are all behind `epoch`. Launches on `stream`; returns the CUDA error of
// the launch (0 on success).
extern "C" int slate_potrf_tile_f32(float* a, int nb, int batch, float* inv,
                                    unsigned* flags, unsigned epoch, void* stream) {
  if (nb <= 0 || batch <= 0) return 0;
  const size_t smem = (2 * BT * PL + BT * PS + WSCR) * sizeof(float);
  int cap = 0;
  cudaError_t e = coresident(dataflow_potrf_tile, smem, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (nb + BT - 1) / BT;
  const long long tasks = static_cast<long long>(batch) * (nt * (nt + 1) / 2);
  const int G = tasks < cap ? static_cast<int>(tasks) : cap;
  void* args[] = {&a, &nb, &batch, &inv, &flags, &epoch};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dataflow_potrf_tile), dim3(G),
                                  dim3(NTH), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
