// The rank-k tail alpha * A * B + beta * C for a short contraction
// (k = a.shape[1] below 128), in true FP32:
//   slate_rank_k_tail_f32
//
// Replaces _rank_k_kernel behind rank_k_tail_pallas
// (slate_tpu/internal/pallas_kernels.py:635-664), the sub-nb remainder of a
// trailing update: on the port's path, the band LU's trailing update
// trail = right - L21 * U12 (linalg/band.py, through tile_kernels.tile_gemm),
// whose contraction is the band block (96 at kl = ku = 32). The Pallas
// kernel's m % 8 / n % 128 gates are Mosaic layout rules; this kernel takes
// any m, n and leading dimensions (unit column stride).
//
// Bound on an H100: bytes at the path's shapes (the arithmetic intensity of
// 2mnk flops over (mk + kn + 2mn) * 4 bytes stays below the FP32 ridge of
// ~20 flops/byte for k < 128 unless m and n are large), and latency at the
// band LU's [32, 96] x [96, 96]. Design: a tiled SIMT product. Each CTA owns
// a 64 x 64 tile of C; it stages the whole A strip [64, k] (transposed) and
// B strip [k, 64] in shared memory once (k <= 127 fits: <= 66 KB), then
// each of its 256 threads accumulates a 4 x 4 micro-tile with FMAs over the
// k terms and writes alpha * acc + beta * c in one fused epilogue (C read
// once, the output written once). No tensor cores: TF32 would keep 10
// mantissa bits, below the bf16_6x tier's 2^-24 contract.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;  // C tile edge
constexpr int AP = TM + 1;  // A strip pitch: the transposing store is conflict-free
constexpr int NTH = 256;

__global__ void __launch_bounds__(NTH)
rank_k(const float* __restrict__ c, int ldc, const float* __restrict__ a, int lda,
       const float* __restrict__ b, int ldb, float* __restrict__ out, int m, int n,
       int k, float alpha, float beta) {
  extern __shared__ float sm[];
  float* As = sm;             // [k][AP]: As[kk * AP + i] = A[i0 + i][kk]
  float* Bs = sm + k * AP;    // [k][TM]: Bs[kk * TM + j] = B[kk][j0 + j]
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int idx = tid; idx < TM * k; idx += NTH) {
    const int i = idx / k, kk = idx % k;  // consecutive threads walk A's row
    As[kk * AP + i] = i0 + i < m ? a[static_cast<size_t>(i0 + i) * lda + kk] : 0.f;
  }
  for (int idx = tid; idx < TM * k; idx += NTH) {
    const int kk = idx / TM, j = idx % TM;  // and B's row
    Bs[kk * TM + j] = j0 + j < n ? b[static_cast<size_t>(kk) * ldb + j0 + j] : 0.f;
  }
  __syncthreads();

  float acc[4][4] = {};
  for (int kk = 0; kk < k; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = As[kk * AP + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = Bs[kk * TM + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= n) continue;
      const float cv = c[static_cast<size_t>(i) * ldc + j];
      out[static_cast<size_t>(i) * n + j] =
          __fadd_rn(__fmul_rn(alpha, acc[r][q]), __fmul_rn(beta, cv));
    }
  }
}

}  // namespace

// c: [m, n] (row stride ldc), a: [m, k] (lda), b: [k, n] (ldb), each with a
// unit column stride; out: [m, n] contiguous, not aliasing c. Returns a CUDA
// error code (0 on success); k outside 1..127 returns an error without
// launching.
extern "C" int slate_rank_k_tail_f32(const float* c, int ldc, const float* a, int lda,
                                     const float* b, int ldb, float* out, int m, int n,
                                     int k, float alpha, float beta, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 1 || k > 127) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (AP + TM) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rank_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + TM - 1) / TM, (m + TM - 1) / TM);
  rank_k<<<grid, NTH, smem, static_cast<cudaStream_t>(stream)>>>(
      c, ldc, a, lda, b, ldb, out, m, n, k, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
