// K2: triangular solve against a lower FP32 factor L [n, n], in place on X:
//   slate_trsm_right_lower_t_f32   X = B * L^-T   (X [m, n], rows independent)
//
// Replaces trsm_right_lower_t_pallas (slate_tpu/internal/pallas_kernels.py),
// the potrf panel solve. It solves, for every row i of X, the forward
// substitution x_i[c] = (b_i[c] - sum_{k<c} L[c][k] x_i[k]) / L[c][c].
// Nothing depends across rows, so one CTA owns 64 of them and no CTA waits
// on another: no diagonal-block inverses are needed (the Pallas kernel
// inverts them to feed the MXU).
// Per 64-wide block of c the CTA first subtracts the solved blocks
// (a 64x64x64 FP32 product per step, L and X tiles streamed through shared
// memory), then substitutes column by column inside the block: 4 lanes per
// row split the dot product and meet by warp shuffles.
// The update products dominate (m n^2 FMAs) and run at the CUDA-core FP32
// rate; the precision policy pins solves to full FP32, so no TF32.
// The left solve K3 has a design of its own (trsm_left.cu).

#include "common.cuh"

namespace {

using slate::NT;
using slate::Tile;
using slate::TS;

// X [m, n] row-major: the solve index c is X's contiguous one.
__global__ void __launch_bounds__(NT)
trsm_lower(const float* __restrict__ l, float* x, int m, int n, int unit) {
  __shared__ Tile sx;
  __shared__ Tile sl;
  const int i0 = blockIdx.x * TS;
  const int ni = min(TS, m - i0);
  float* xb = x + static_cast<size_t>(i0) * n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int c0 = 0; c0 < n; c0 += TS) {
    const int wc = min(TS, n - c0);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < c0; k0 += TS) {  // solved blocks: k0 + TS <= c0
      slate::load_tile(sx, xb + k0, n, ni, TS);
      slate::load_tile(sl, l + (size_t)c0 * n + k0, n, wc, TS);
      __syncthreads();
      slate::tile_abt(sx, sl, TS, acc);
      __syncthreads();
    }
    slate::load_tile(sx, xb + c0, n, ni, wc);
    slate::load_tile(sl, l + (size_t)c0 * n + c0, n, wc, wc);
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
      const int ii = idx / TS, k = idx % TS;
      if (ii < ni && k < wc) xb[static_cast<size_t>(ii) * n + c0 + k] = sx[ii][k];
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
  trsm_lower<<<g, NT, 0, static_cast<cudaStream_t>(stream)>>>(l, x, m, n, unit);
  return static_cast<int>(cudaGetLastError());
}
