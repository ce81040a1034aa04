// Segmented panel transpose in FP32:
//   slate_panel_transpose_f32   y_s[c][r] = x_s[r][c]   for s < S, r < R, c < C
//
// One entry point serves every layout kernel of the LU panel path
// (slate_tpu/internal/panel_plu.py): transpose_tiled (S = 1, [m, k] -> [k, m]),
// transpose_fold and fold_panel (S = 8, row-major [h, w] -> [8, w, h/8]),
// unfold_transpose and unfold_panel (the inverse, [8, w, L] -> [8L, w]).
// Each segment s is a matrix x_s = x + s * xb with rows R and columns C,
// row stride xr and unit column stride; the result y_s = y + s * yb has
// rows C, columns R, row stride yr. So fold_panel reads a strided column
// window of the dense matrix in place, and unfold_panel can write one.
//
// Bound by bytes (each element read once and written once; no arithmetic).
// Design: one CTA moves a 32x32 tile through shared memory, padded to 33
// columns so the transposed read of the tile hits 32 banks; 32x8 threads,
// four rows each. The global read walks c and the global write walks r,
// both along the unit stride, so both sides coalesce. The ragged edge is
// masked; any R, C >= 1.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;   // tile edge
constexpr int TY = 8;    // thread rows; each thread moves TT / TY elements

__global__ void __launch_bounds__(TT * TY)
panel_transpose(const float* __restrict__ x, float* __restrict__ y, int R, int C,
                long long xr, long long xb, long long yr, long long yb) {
  __shared__ float t[TT][TT + 1];
  const int s = blockIdx.z;
  const int c0 = blockIdx.x * TT, r0 = blockIdx.y * TT;
  const float* xs = x + s * xb;
  float* ys = y + s * yb;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < TT; k += TY) {
    const int r = r0 + ty + k, c = c0 + tx;
    if (r < R && c < C) t[ty + k][tx] = xs[r * xr + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TT; k += TY) {
    const int c = c0 + ty + k, r = r0 + tx;
    if (r < R && c < C) ys[c * yr + r] = t[tx][ty + k];
  }
}

}  // namespace

// Returns the CUDA launch error (0 on success).
extern "C" int slate_panel_transpose_f32(const float* x, float* y, int S, int R, int C,
                                         long long xr, long long xb, long long yr,
                                         long long yb, void* stream) {
  if (S <= 0 || R <= 0 || C <= 0) return 0;
  const dim3 block(TT, TY);
  const dim3 grid((C + TT - 1) / TT, (R + TT - 1) / TT, S);
  panel_transpose<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, R, C, xr, xb, yr, yb);
  return static_cast<int>(cudaGetLastError());
}
