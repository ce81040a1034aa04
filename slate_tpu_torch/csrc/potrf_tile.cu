// Lower Cholesky of one [nb, nb] FP32 tile, in place, upper triangle zeroed.
//
// Replaces potrf_tile_pallas (slate_tpu/internal/pallas_kernels.py), which
// keeps the whole tile in VMEM. A block has at most 227 KB of shared memory
// and the tile is 4 MB at nb = 1024, so here the tile stays in global
// memory (it fits in L2) and a host loop walks it in 64-column blocks. Per
// block j0 of width w:
//   chol_diag  one CTA: unblocked Cholesky of the w x w diagonal block in
//              shared memory, its inverse (to `inv`), and zeros for the
//              upper part of the block rows;
//   panel      a grid of CTAs: P = T * inv^T for the rows below the block;
//   trailing   a grid of CTAs: A22 -= P * P^T on the lower 64x64 tiles.
// Math is FP32 FMAs on the CUDA cores (the precision policy pins tile
// factors to full FP32, so no TF32 tensor-core path). A non-positive pivot
// gives sqrtf(<0) = NaN (or a zero that turns into inf/NaN below it), which
// reaches the diagonal so the caller's finite guard reports the block.

#include "common.cuh"

namespace {

using slate::NT;
using slate::Tile;
using slate::TS;

__global__ void __launch_bounds__(NT)
chol_diag(float* a, int nb, int j0, float* inv) {
  __shared__ Tile sd;
  __shared__ Tile si;
  const int w = min(TS, nb - j0);
  float* d = a + (size_t)j0 * nb + j0;
  slate::load_tile<true>(sd, d, nb, 1, w, w);
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) si[idx / TS][idx % TS] = 0.f;
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    const float piv = sqrtf(sd[j][j]);
    __syncthreads();  // every thread has read sd[j][j] before it changes
    if (threadIdx.x == 0) sd[j][j] = piv;
    for (int i = j + 1 + threadIdx.x; i < w; i += NT) sd[i][j] /= piv;
    __syncthreads();
    const int r = w - j - 1;  // trailing lower part of the block
    for (int idx = threadIdx.x; idx < r * r; idx += NT) {
      const int i = j + 1 + idx / r, k = j + 1 + idx % r;
      if (k <= i) sd[i][k] -= sd[i][j] * sd[k][j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) {
    const int i = idx / TS, k = idx % TS;
    if (k > i) sd[i][k] = 0.f;
  }
  __syncthreads();

  // inverse of L by forward substitution, one column per thread
  if (threadIdx.x < w) {
    const int c = threadIdx.x;
    for (int i = c; i < w; ++i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s = fmaf(-sd[i][k], si[k][c], s);
      si[i][c] = s / sd[i][i];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < w * w; idx += NT) {
    const int i = idx / w, k = idx % w;
    d[(size_t)i * nb + k] = sd[i][k];
  }
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) inv[idx] = si[idx / TS][idx % TS];
  // upper triangle of the tile: the block rows right of the diagonal block
  const int right = nb - j0 - w;
  for (int idx = threadIdx.x; idx < w * right; idx += NT) {
    const int i = idx / right, k = idx % right;
    d[(size_t)i * nb + w + k] = 0.f;
  }
}

__global__ void __launch_bounds__(NT)
panel(float* a, int nb, int j0, const float* inv) {
  __shared__ Tile st;
  __shared__ Tile si;
  const int w = min(TS, nb - j0);
  const int r0 = j0 + w + blockIdx.x * TS;
  const int rows = min(TS, nb - r0);
  float* t = a + (size_t)r0 * nb + j0;
  slate::load_tile<true>(st, t, nb, 1, rows, w);
  slate::load_tile<true>(si, inv, TS, 1, TS, TS);
  __syncthreads();
  float acc[4][4] = {};
  slate::tile_abt(st, si, w, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      if (i < rows && k < w) t[(size_t)i * nb + k] = acc[r][c];
    }
}

__global__ void __launch_bounds__(NT)
trailing(float* a, int nb, int j0) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;  // upper tiles: junk by contract, zeroed later
  __shared__ Tile sp;
  __shared__ Tile sq;
  const int w = min(TS, nb - j0);
  const int t0 = j0 + w;
  const int ri = t0 + bi * TS, rj = t0 + bj * TS;
  const int rows = min(TS, nb - ri), cols = min(TS, nb - rj);
  slate::load_tile<true>(sp, a + (size_t)ri * nb + j0, nb, 1, rows, w);
  slate::load_tile<true>(sq, a + (size_t)rj * nb + j0, nb, 1, cols, w);
  __syncthreads();
  float acc[4][4] = {};
  slate::tile_abt(sp, sq, w, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* c0 = a + (size_t)ri * nb + rj;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      if (i < rows && k < cols) c0[(size_t)i * nb + k] -= acc[r][c];
    }
}

}  // namespace

// a: [nb, nb] row-major FP32 on the device, factored in place.
// inv: TS*TS floats of scratch. Launches on `stream`; returns the CUDA
// error of the launches (0 on success).
extern "C" int slate_potrf_tile_f32(float* a, int nb, float* inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < nb; j0 += TS) {
    const int w = min(TS, nb - j0);
    const int rem = nb - j0 - w;
    chol_diag<<<1, NT, 0, s>>>(a, nb, j0, inv);
    if (rem > 0) {
      const int g = (rem + TS - 1) / TS;
      panel<<<g, NT, 0, s>>>(a, nb, j0, inv);
      trailing<<<dim3(g, g), NT, 0, s>>>(a, nb, j0);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
