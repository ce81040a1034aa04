// Partial-pivot LU of a rows-at-origin [h, w] panel with physical row
// swaps, in FP32:
//   slate_panel_plu_swap_f32
//
// Replaces _panel_plu_kernel behind panel_plu_pallas
// (slate_tpu/internal/pallas_kernels.py:464-529), Aasen's panel (hetrf step
// 5 through tile_kernels.panel_lu_factor). It factors x = a[h][w] (row-major,
// in place) column by column, for j < min(h, w):
//   score_i = |x[i][j]| for positions i >= j, -1 above; r = the lowest
//     position whose score equals the maximum (LAPACK isamax: the tie goes to
//     the current position, after the earlier swaps). A NaN score makes the
//     maximum NaN, no score equals it, and r = h: nothing is selected;
//   rowr = x[r] (zeros when r = h), rowj = x[j]; x[j] = rowr, x[r] = rowj:
//     whole rows move, the L columns already factored included;
//   pv = rowr[j] (0 when r = h); info += (pv == 0); safe = pv, or 1 if 0;
//   l_i = x[i][j] / safe for i > j, 0 for i <= j; u_k = rowr[k] for k > j,
//     0 for k <= j; x[i][k] -= l_i * u_k for every i and k, then
//     x[i][j] = l_i for i > j; piv[j] = r.
// The full rank-1 update is the JAX kernel's; it changes an entry off the
// block x[j+1:, j+1:] only through IEEE arithmetic on a non-finite factor
// (l_i * 0 or 0 * u_k is NaN when l_i or u_k is infinite or NaN), so the
// kernel updates that block and writes NaN where such a product is NaN.
// Products and differences are rounded one at a time (no FMA contraction)
// and the multipliers are true divisions, as the plain PyTorch version
// computes them.
//
// Bound on an H100: latency. The bytes (2 h w 4: 33 MB at [16128, 256]) and
// flops (h w^2) are tens of microseconds; the w dependent column steps each
// need a reduction over all h rows and a row exchange between two CTAs.
// Design, K4's (csrc/panel_plu.cu): one cooperative launch with one CTA per
// SM; each CTA holds its band of R consecutive positions (<= 123 x 256 f32 =
// 126 KB at h = 16128) in shared memory for the whole call, column-major
// with an odd pitch so that walks along a row and along a column are both
// free of bank conflicts. Per column: each CTA publishes its local winner
// (score, position) with that row's w values, and the CTA holding position j
// publishes row j, to global scratch double-buffered by column parity; one
// grid barrier; every CTA reduces the candidates in the same total order (a
// NaN first, then the larger score, then the lower position), so all agree
// on r; the holder of j writes rowr into its row j, the holder of r writes
// rowj into its row r, and every CTA updates its own rows. One barrier per
// column suffices: a slot of parity j % 2 is rewritten only after the
// barrier of column j + 1, which every CTA passes after reading column j's
// slot.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int WMAX = 256;     // widest panel
constexpr int NTH = 512;      // threads per CTA
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds (keeps small h on few CTAs)

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
plu_swap(float* __restrict__ a, int* __restrict__ piv, int* __restrict__ info,
         float* cand_s, int* cand_r, float* cand_row, float* row_j, int h, int w,
         int R, int P) {
  extern __shared__ float sm[];
  float* sx = sm;          // [w][P]: sx[c * P + i] = x[r0 + i][c]
  float* su = sx + w * P;  // [w] the pivot row of this step
  __shared__ float red_s[NTH / 32];
  __shared__ int red_r[NTH / 32];
  __shared__ float win_s;
  __shared__ int win_r, loc_i, bad_u;

  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = g * R;
  const int nr = min(R, h - r0);

  for (int idx = tid; idx < nr * w; idx += NTH) {
    const int i = idx / w, c = idx % w;
    sx[c * P + i] = a[static_cast<size_t>(r0 + i) * w + c];
  }
  __syncthreads();

  int zeros = 0;
  const int kmax = min(h, w);
  for (int j = 0; j < kmax; ++j) {
    const int slot = (j & 1) * G;
    // local candidate: the best of this CTA's positions >= j in column j
    float bs = -INFINITY;
    int br = INT_MAX;
    for (int i = max(0, j - r0) + tid; i < nr; i += NTH) {
      const float sc = fabsf(sx[j * P + i]);
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
        loc_i = br == INT_MAX ? -1 : br - r0;
      }
    }
    __syncthreads();
    if (loc_i >= 0)
      for (int k = tid; k < w; k += NTH)
        __stcg(cand_row + static_cast<size_t>(slot + g) * w + k, sx[k * P + loc_i]);
    if (j >= r0 && j < r0 + nr)
      for (int k = tid; k < w; k += NTH)
        __stcg(row_j + (j & 1) * w + k, sx[k * P + (j - r0)]);

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
        bad_u = 0;
      }
    }
    __syncthreads();
    const bool none = isnan(win_s);
    const int wr = win_r;
    for (int k = tid; k < w; k += NTH) {
      const float u =
          none ? 0.f : __ldcg(cand_row + static_cast<size_t>(slot + wr / R) * w + k);
      su[k] = u;
      if (k > j && !isfinite(u)) bad_u = 1;
    }
    __syncthreads();
    // the exchange: rowr into position j, rowj into position r
    if (j >= r0 && j < r0 + nr)
      for (int k = tid; k < w; k += NTH) sx[k * P + (j - r0)] = su[k];
    if (!none && wr != j && wr >= r0 && wr < r0 + nr)
      for (int k = tid; k < w; k += NTH)
        sx[k * P + (wr - r0)] = __ldcg(row_j + (j & 1) * w + k);
    const float pv = su[j];
    const float safe = pv == 0.f ? 1.f : pv;
    if (tid == 0) {
      zeros += pv == 0.f;
      if (g == 0) piv[j] = none ? h : wr;
    }
    __syncthreads();
    // multipliers of the positions below j, then the update of every row
    for (int i = max(0, j + 1 - r0) + tid; i < nr; i += NTH)
      sx[j * P + i] = __fdiv_rn(sx[j * P + i], safe);
    __syncthreads();
    const bool bu = bad_u != 0;
    for (int idx = tid; idx < nr * w; idx += NTH) {
      const int k = idx / nr, i = idx % nr;
      if (k == j) continue;
      const float x = sx[k * P + i];
      if (r0 + i > j) {
        const float l = sx[j * P + i];
        if (k > j)
          sx[k * P + i] = __fsub_rn(x, __fmul_rn(l, su[k]));
        else if (!isfinite(l))
          sx[k * P + i] = NAN;
      } else if (bu && k > j && !isfinite(su[k])) {
        sx[k * P + i] = NAN;
      }
    }
    __syncthreads();
  }

  if (g == 0 && tid == 0) *info = zeros;
  for (int idx = tid; idx < nr * w; idx += NTH) {
    const int i = idx / w, c = idx % w;
    a[static_cast<size_t>(r0 + i) * w + c] = sx[c * P + i];
  }
}

}  // namespace

// a: [h, w] row-major, factored in place; piv: [min(h, w)] int32; info: [1]
// int32. Scratch from the caller: cand_s and cand_r hold 2 * max_ctas
// entries, cand_row 2 * max_ctas * w, row_j 2 * w. Returns a CUDA error code
// (0 on success); a panel wider than 256, a band of rows that does not fit
// one SM's shared memory, or a grid that cannot be co-resident returns an
// error without launching.
extern "C" int slate_panel_plu_swap_f32(float* a, int* piv, int* info, float* cand_s,
                                        int* cand_r, float* cand_row, float* row_j,
                                        int max_ctas, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (w > WMAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int R = (h + sms - 1) / sms;
  if (R < MIN_ROWS) R = MIN_ROWS;
  const int G = (h + R - 1) / R;
  if (G > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
  const int P = R | 1;  // odd pitch: row and column walks are conflict-free
  const size_t smem = (static_cast<size_t>(w) * P + w) * sizeof(float);
  if (smem + 1024 > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(plu_swap, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plu_swap, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a, &piv, &info, &cand_s, &cand_r, &cand_row, &row_j,
                  &h, &w, &R, const_cast<int*>(&P)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(plu_swap), dim3(G), dim3(NTH),
                                  args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
