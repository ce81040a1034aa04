// Pieces of the FP32 tile kernel K2 (trsm_lower.cu): a 64x64 tile in
// shared memory, its loader, and the 4x4-per-thread product of two such
// tiles.
#pragma once

#include <cuda_runtime.h>

namespace slate {

constexpr int TS = 64;       // tile edge: column-block width and output tile
constexpr int NT = 256;      // threads per block, a 16x16 grid of 4x4 micro-tiles
constexpr int LDS = TS + 1;  // padded shared row: column walks hit 32 banks

typedef float Tile[TS][LDS];

// s[i][k] = g[i * si + k] for i < rows, k < cols, zero elsewhere in the
// tile; consecutive threads walk k, so the global load coalesces.
__device__ __forceinline__ void load_tile(Tile& s, const float* g, size_t si, int rows,
                                          int cols) {
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) {
    const int i = idx / TS, k = idx % TS;
    s[i][k] = (i < rows && k < cols) ? g[i * si + k] : 0.f;
  }
}

// acc[r][c] += sum_{k < w} a[ty + 16r][k] * b[tx + 16c][k]  (A times B^T).
// Within a warp tx runs over 16 lanes: b's rows land on distinct banks
// thanks to the padded row, a's two rows are broadcasts.
__device__ __forceinline__ void tile_abt(const Tile& a, const Tile& b, int w,
                                         float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k = 0; k < w; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[ty + 16 * r][k];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[tx + 16 * c][k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

}  // namespace slate
