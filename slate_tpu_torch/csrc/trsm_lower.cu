// Triangular solves against a lower FP32 factor L [n, n], in place on X:
//   slate_trsm_right_lower_t_f32   X = B * L^-T   (X [m, n], rows independent)
//   slate_trsm_left_lower_f32      X = L^-1 * B   (X [n, m], columns independent)
//
// Replace trsm_right_lower_t_pallas and trsm_left_lower_pallas
// (slate_tpu/internal/pallas_kernels.py). Both solve, for every independent
// index i (a row of X in the first, a column in the second), the forward
// substitution x_i[c] = (b_i[c] - sum_{k<c} L[c][k] x_i[k]) / L[c][c]; only
// the strides of X differ. Nothing depends across independent indices, so
// one CTA owns 64 of them and no CTA waits on another: no diagonal-block
// inverses are needed (the Pallas kernels invert them to feed the MXU).
// Per 64-wide block of c the CTA first subtracts the solved blocks
// (a 64x64x64 FP32 product per step, L and X tiles streamed through shared
// memory), then substitutes column by column inside the block: 4 lanes per
// independent index split the dot product and meet by warp shuffles.
// The update products dominate (m n^2 FMAs) and run at the CUDA-core FP32
// rate; the precision policy pins solves to full FP32, so no TF32.

#include "common.cuh"

namespace {

using slate::NT;
using slate::Tile;
using slate::TS;

// KCONTIG: the solve index c is X's contiguous one (right solve).
template <bool KCONTIG>
__global__ void __launch_bounds__(NT)
trsm_lower(const float* __restrict__ l, float* x, int m, int n, size_t si, size_t sk,
           int unit) {
  __shared__ Tile sx;
  __shared__ Tile sl;
  const int i0 = blockIdx.x * TS;
  const int ni = min(TS, m - i0);
  float* xb = x + i0 * si;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int c0 = 0; c0 < n; c0 += TS) {
    const int wc = min(TS, n - c0);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < c0; k0 += TS) {  // solved blocks: k0 + TS <= c0
      slate::load_tile<KCONTIG>(sx, xb + k0 * sk, si, sk, ni, TS);
      slate::load_tile<true>(sl, l + (size_t)c0 * n + k0, n, 1, wc, TS);
      __syncthreads();
      slate::tile_abt(sx, sl, TS, acc);
      __syncthreads();
    }
    slate::load_tile<KCONTIG>(sx, xb + c0 * sk, si, sk, ni, wc);
    slate::load_tile<true>(sl, l + (size_t)c0 * n + c0, n, 1, wc, wc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sx[ty + 16 * r][tx + 16 * c] -= acc[r][c];
    __syncthreads();

    // column substitution inside the block: row i of sx is owned by the
    // four consecutive lanes 4i..4i+3 of one warp, so a warp barrier
    // orders the steps
    const int i = threadIdx.x / 4, lane = threadIdx.x % 4;
    for (int c = 0; c < wc; ++c) {
      float s = 0.f;
      for (int k = lane; k < c; k += 4) s = fmaf(sl[c][k], sx[i][k], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float v = sx[i][c] - s;
      __syncwarp();
      if (lane == 0) sx[i][c] = unit ? v : v / sl[c][c];
      __syncwarp();
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TS * TS; idx += NT) {
      const int ii = KCONTIG ? idx / TS : idx % TS;
      const int k = KCONTIG ? idx % TS : idx / TS;
      if (ii < ni && k < wc) xb[ii * si + (c0 + k) * sk] = sx[ii][k];
    }
    __syncthreads();
  }
}

}  // namespace

// l: [n, n] row-major, lower triangle read. x: [m, n] row-major, holds B on
// entry and X on exit. Returns the CUDA launch error (0 on success).
extern "C" int slate_trsm_right_lower_t_f32(const float* l, float* x, int m, int n,
                                            int unit, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int g = (m + TS - 1) / TS;
  trsm_lower<true><<<g, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      l, x, m, n, static_cast<size_t>(n), 1, unit);
  return static_cast<int>(cudaGetLastError());
}

// l: [n, n] row-major, lower triangle read. x: [n, m] row-major, holds B on
// entry and X on exit. Returns the CUDA launch error (0 on success).
extern "C" int slate_trsm_left_lower_f32(const float* l, float* x, int n, int m,
                                         int unit, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int g = (m + TS - 1) / TS;
  trsm_lower<false><<<g, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      l, x, m, n, 1, static_cast<size_t>(m), unit);
  return static_cast<int>(cudaGetLastError());
}
