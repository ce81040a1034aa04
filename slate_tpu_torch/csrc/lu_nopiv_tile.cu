// Unpivoted LU of one [nb, nb] FP32 tile, in place, compact unit-L/U:
//   slate_lu_nopiv_tile_f32
//
// Replaces lu_nopiv_tile_pallas (slate_tpu/internal/pallas_kernels.py), which
// keeps the whole tile in VMEM. As in potrf_tile.cu the tile stays in global
// memory (4 MB at nb = 1024, resident in L2) and a host loop walks it in
// 64-column blocks. Per block j0 of width w:
//   lu_diag      one CTA: unblocked LU of the w x w diagonal block in shared
//                memory, then the inverse of its unit-lower L (to inv) and of
//                its safe U (to inv + TS*TS);
//   lu_l21       a grid of CTAs: L21 = A21 * U11^-1 for the rows below;
//   lu_u12       a grid of CTAs: U12 = L11^-1 * A12 for the columns right;
//   lu_trailing  a grid of CTAs: A22 -= L21 * U12 on 64x64 tiles.
// A zero pivot keeps its 0 on the U diagonal; the elimination and the
// inverse use 1 in its place (the Pallas kernel's safe diagonal), so the
// caller counts zero pivots off the result's diagonal. Math is FP32 FMAs on
// the CUDA cores. Bound on an H100: FP32 operations (2 nb^3 / 3) at large
// nb, but each diagonal block is latency-bound on one CTA.

#include "common.cuh"

namespace {

using slate::NT;
using slate::Tile;
using slate::TS;

__global__ void __launch_bounds__(NT)
lu_diag(float* a, int nb, int j0, float* inv) {
  __shared__ Tile sd;
  __shared__ Tile sx;  // L11^-1, then (safe U11)^-1 (48 KB of static
                       // shared memory do not hold three tiles)
  const int w = min(TS, nb - j0);
  float* d = a + (size_t)j0 * nb + j0;
  slate::load_tile<true>(sd, d, nb, 1, w, w);
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) sx[idx / TS][idx % TS] = 0.f;
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    const float p = sd[j][j];
    const float ps = p == 0.f ? 1.f : p;
    __syncthreads();  // every thread has read sd[j][j]
    for (int i = j + 1 + threadIdx.x; i < w; i += NT) sd[i][j] /= ps;
    __syncthreads();
    const int r = w - j - 1;  // trailing part of the block
    for (int idx = threadIdx.x; idx < r * r; idx += NT) {
      const int i = j + 1 + idx / r, k = j + 1 + idx % r;
      sd[i][k] -= sd[i][j] * sd[j][k];
    }
    __syncthreads();
  }

  // inverses, one column per thread: unit-lower L by forward
  // substitution, then safe upper U by back substitution
  if (threadIdx.x < w) {
    const int c = threadIdx.x;
    for (int i = c; i < w; ++i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s = fmaf(-sd[i][k], sx[k][c], s);
      sx[i][c] = s;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT) {
    inv[idx] = sx[idx / TS][idx % TS];
    sx[idx / TS][idx % TS] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < w) {
    const int c = threadIdx.x;
    for (int i = c; i >= 0; --i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int k = i + 1; k <= c; ++k) s = fmaf(-sd[i][k], sx[k][c], s);
      const float p = sd[i][i];
      sx[i][c] = s / (p == 0.f ? 1.f : p);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < w * w; idx += NT) {
    const int i = idx / w, k = idx % w;
    d[(size_t)i * nb + k] = sd[i][k];
  }
  for (int idx = threadIdx.x; idx < TS * TS; idx += NT)
    inv[TS * TS + idx] = sx[idx / TS][idx % TS];
}

// L21 = A21 * U11^-1: acc[i][c] = sum_k A21[i][k] * Ui[k][c]; tile_abt
// takes B^T, so Ui is loaded transposed.
__global__ void __launch_bounds__(NT)
lu_l21(float* a, int nb, int j0, const float* inv) {
  __shared__ Tile st;
  __shared__ Tile sut;
  const int w = min(TS, nb - j0);
  const int r0 = j0 + w + blockIdx.x * TS;
  const int rows = min(TS, nb - r0);
  float* t = a + (size_t)r0 * nb + j0;
  slate::load_tile<true>(st, t, nb, 1, rows, w);
  slate::load_tile<false>(sut, inv + TS * TS, 1, TS, TS, TS);
  __syncthreads();
  float acc[4][4] = {};
  slate::tile_abt(st, sut, w, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      if (i < rows && k < w) t[(size_t)i * nb + k] = acc[r][c];
    }
}

// U12 = L11^-1 * A12: acc[i][c] = sum_k Li[i][k] * A12[k][c]; A12's tile is
// loaded transposed.
__global__ void __launch_bounds__(NT)
lu_u12(float* a, int nb, int j0, const float* inv) {
  __shared__ Tile sli;
  __shared__ Tile sbt;
  const int w = min(TS, nb - j0);
  const int c0 = j0 + w + blockIdx.x * TS;
  const int cols = min(TS, nb - c0);
  float* t = a + (size_t)j0 * nb + c0;
  slate::load_tile<true>(sli, inv, TS, 1, TS, TS);
  slate::load_tile<false>(sbt, t, 1, nb, cols, w);
  __syncthreads();
  float acc[4][4] = {};
  slate::tile_abt(sli, sbt, w, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, k = tx + 16 * c;
      if (i < w && k < cols) t[(size_t)i * nb + k] = acc[r][c];
    }
}

// A22 -= L21 * U12 on every 64x64 tile of the trailing matrix.
__global__ void __launch_bounds__(NT)
lu_trailing(float* a, int nb, int j0) {
  __shared__ Tile sl;
  __shared__ Tile sut;
  const int w = min(TS, nb - j0);
  const int t0 = j0 + w;
  const int ri = t0 + blockIdx.y * TS, rj = t0 + blockIdx.x * TS;
  const int rows = min(TS, nb - ri), cols = min(TS, nb - rj);
  slate::load_tile<true>(sl, a + (size_t)ri * nb + j0, nb, 1, rows, w);
  slate::load_tile<false>(sut, a + (size_t)j0 * nb + rj, 1, nb, cols, w);
  __syncthreads();
  float acc[4][4] = {};
  slate::tile_abt(sl, sut, w, acc);
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
// inv: 2*TS*TS floats of scratch. Launches on `stream`; returns the CUDA
// error of the launches (0 on success).
extern "C" int slate_lu_nopiv_tile_f32(float* a, int nb, float* inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < nb; j0 += TS) {
    const int w = min(TS, nb - j0);
    const int rem = nb - j0 - w;
    lu_diag<<<1, NT, 0, s>>>(a, nb, j0, inv);
    if (rem > 0) {
      const int g = (rem + TS - 1) / TS;
      lu_l21<<<g, NT, 0, s>>>(a, nb, j0, inv);
      lu_u12<<<g, NT, 0, s>>>(a, nb, j0, inv);
      lu_trailing<<<dim3(g, g), NT, 0, s>>>(a, nb, j0);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
