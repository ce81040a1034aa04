// Pivoted LU of one 128-column block of a segmented column-major panel,
// pivoting by index (rows are never moved), in FP32:
//   slate_plu_block_f32
//
// Replaces _plu_kernel / _plu_kernel_folded (slate_tpu/internal/panel_plu.py),
// which serve _plu_call (S = 1), _plu_call_folded and plu_call_folded_block
// (S = 8). The panel buffer is p[S][nb][L], h = S * L rows, row r at
// (r / L, r % L); column c of segment q is contiguous over l. The kernel
// factors columns blk*128 .. blk*128+127 in place against the activity mask
// act[h] (1 = row may still pivot), updated in place:
//   for j in 0..127:
//     pivot r = the active row with the largest |x[., j]|, lowest index on
//       ties; inactive rows score -1 (so with no active row the lowest row
//       is taken, and nothing is updated). A NaN among the active scores
//       selects no row: piv[j] = h, the mask is kept, and the pivot value
//       is NaN, so every active row turns NaN from column j on (the JAX
//       kernel's max-then-index-min does the same: mx is NaN, score >= mx
//       holds nowhere, min gives h);
//     info += (pivot value == 0); rsafe = 1 on a zero pivot, else 1/pivot;
//     act[r] = 0; each active row i: x[i][j] *= rsafe, then
//       x[i][k] -= x[r][k] * x[i][j] for k > j (eager right-looking update).
//   Rows inactive on entry are never written.
// The JAX kernel's IB=8 delayed strip update and [8, 8] Neumann inverse only
// feed the MXU; the eager update is the same in exact arithmetic. Products
// and differences are rounded one at a time (no FMA contraction), as the
// plain PyTorch version computes them, so kernel and plain version agree
// bit for bit.
//
// Bound on an H100: neither bytes (2 h 128 4 B, 16.8 MB at h = 16384) nor
// operations (h 128^2 flops) but latency: 128 dependent steps, each a
// reduction over all h rows. Design: one cooperative launch with one CTA
// per SM (grid sized from the occupancy query; the launch fails, never
// hangs, if the grid cannot be co-resident). Each CTA keeps its share of
// the rows (<= 125 x 128 f32 = 64 KB at h = 16384) in shared memory for the
// whole call. Per column: each CTA publishes its local winner (score, row)
// and that row's remaining values to global scratch, one grid barrier, then
// every CTA reduces the candidates with the same total order, so all agree
// on the winner, and updates its own rows. The scratch is double-buffered
// by column parity, so one barrier per column suffices: a CTA can only
// overwrite slot j % 2 after the barrier of column j + 1, which every CTA
// passes only once it has read column j's slot. Scratch is read and written
// with the L1-bypassing __ldcg / __stcg, since other SMs write it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int W = 128;        // block width: columns factored per call
constexpr int NTH = 256;      // threads per CTA
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds (keeps small h on few CTAs)

// The total order of pivot candidates: a NaN score first, then the larger
// score, then the lower row. Rows are unique, so every reduction order
// reaches the same winner.
__device__ __forceinline__ bool better(float as, int ar, float bs, int br) {
  const bool an = isnan(as), bn = isnan(bs);
  if (an != bn) return an;
  if (!an && as != bs) return as > bs;
  return ar < br;
}

__device__ __forceinline__ void warp_best(float& s, int& r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const int orow = __shfl_xor_sync(0xffffffffu, r, o);
    if (better(os, orow, s, r)) {
      s = os;
      r = orow;
    }
  }
}

__global__ void __launch_bounds__(NTH)
plu_block(float* __restrict__ p, float* __restrict__ act, int* __restrict__ piv,
          int* __restrict__ info, float* cand_s, int* cand_r, float* cand_row, int nb,
          int L, int blk, int R, int h) {
  extern __shared__ float sm[];
  float* sx = sm;              // [W][R]: sx[c * R + i] = x[r0 + i][c]
  float* sact = sx + W * R;    // [R] mask, updated
  float* sact0 = sact + R;     // [R] mask on entry
  float* su = sact0 + R;       // [W] the pivot row of this step
  __shared__ float red_s[NTH / 32];
  __shared__ int red_r[NTH / 32];
  __shared__ float win_s;
  __shared__ int win_r, loc_i;

  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = g * R;
  const int nr = min(R, h - r0);
  const size_t seg = static_cast<size_t>(nb) * L;
  const size_t col0 = static_cast<size_t>(blk) * W;

  for (int idx = tid; idx < W * R; idx += NTH) {
    const int c = idx / R, i = idx % R;
    if (i < nr) {
      const int r = r0 + i;
      sx[idx] = p[(r / L) * seg + (col0 + c) * L + r % L];
    }
  }
  for (int i = tid; i < nr; i += NTH) sact[i] = sact0[i] = act[r0 + i];
  __syncthreads();

  int zeros = 0;
  for (int j = 0; j < W; ++j) {
    const int slot = (j & 1) * G;
    // local candidate: the best of this CTA's rows in column j
    float bs = -INFINITY;
    int br = INT_MAX;
    for (int i = tid; i < nr; i += NTH) {
      const float sc = sact[i] > 0.f ? fabsf(sx[j * R + i]) : -1.f;
      if (better(sc, r0 + i, bs, br)) {
        bs = sc;
        br = r0 + i;
      }
    }
    warp_best(bs, br);
    if (lane == 0) {
      red_s[warp] = bs;
      red_r[warp] = br;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < NTH / 32 ? red_s[lane] : -INFINITY;
      br = lane < NTH / 32 ? red_r[lane] : INT_MAX;
      warp_best(bs, br);
      if (lane == 0) {
        __stcg(cand_s + slot + g, bs);
        __stcg(cand_r + slot + g, br);
        loc_i = br - r0;
      }
    }
    __syncthreads();
    for (int k = j + tid; k < W; k += NTH)
      __stcg(cand_row + static_cast<size_t>(slot + g) * W + k, sx[k * R + loc_i]);

    grid.sync();

    // the global winner, reduced in the same order by every CTA
    if (warp == 0) {
      bs = -INFINITY;
      br = INT_MAX;
      for (int q = lane; q < G; q += 32) {
        const float cs = __ldcg(cand_s + slot + q);
        const int cr = __ldcg(cand_r + slot + q);
        if (better(cs, cr, bs, br)) {
          bs = cs;
          br = cr;
        }
      }
      warp_best(bs, br);
      if (lane == 0) {
        win_s = bs;
        win_r = br;
      }
    }
    __syncthreads();
    const bool none = isnan(win_s);
    const int wr = win_r;
    for (int k = j + tid; k < W; k += NTH)
      su[k] = none ? NAN
                   : __ldcg(cand_row + static_cast<size_t>(slot + wr / R) * W + k);
    __syncthreads();
    const float pv = su[j];
    const float rsafe = pv == 0.f ? 1.f : 1.f / pv;
    if (tid == 0) {
      zeros += pv == 0.f;
      if (g == 0) piv[j] = none ? h : wr;
      if (!none && wr >= r0 && wr < r0 + nr) sact[wr - r0] = 0.f;
    }
    __syncthreads();
    for (int i = tid; i < nr; i += NTH)
      if (sact[i] > 0.f) sx[j * R + i] = __fmul_rn(sx[j * R + i], rsafe);
    __syncthreads();
    const int nk = W - 1 - j;
    for (int idx = tid; idx < nk * nr; idx += NTH) {
      const int i = idx % nr, k = j + 1 + idx / nr;
      if (sact[i] > 0.f)
        sx[k * R + i] = __fsub_rn(sx[k * R + i], __fmul_rn(su[k], sx[j * R + i]));
    }
    __syncthreads();
  }

  if (g == 0 && tid == 0) *info = zeros;
  for (int idx = tid; idx < W * R; idx += NTH) {
    const int c = idx / R, i = idx % R;
    if (i < nr && sact0[i] > 0.f) {
      const int r = r0 + i;
      p[(r / L) * seg + (col0 + c) * L + r % L] = sx[idx];
    }
  }
  for (int i = tid; i < nr; i += NTH) act[r0 + i] = sact[i];
}

}  // namespace

// p: [S, nb, L] contiguous; act: [S * L]; piv: [128] int32; info: [1] int32.
// Scratch from the caller: cand_s and cand_r hold 2 * max_ctas entries,
// cand_row 2 * max_ctas * 128. Returns a CUDA error code (0 on success);
// a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge without launching.
extern "C" int slate_plu_block_f32(float* p, float* act, int* piv, int* info,
                                   float* cand_s, int* cand_r, float* cand_row,
                                   int max_ctas, int S, int nb, int L, int blk,
                                   void* stream) {
  const int h = S * L;
  if (h <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int R = (h + sms - 1) / sms;
  if (R < MIN_ROWS) R = MIN_ROWS;
  const int G = (h + R - 1) / R;
  if (G > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(W) * R + 2 * R + W) * sizeof(float);
  e = cudaFuncSetAttribute(plu_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plu_block, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p, &act, &piv, &info, &cand_s, &cand_r, &cand_row,
                  &nb, &L, &blk, &R, const_cast<int*>(&h)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(plu_block), dim3(G), dim3(NTH),
                                  args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
