// The rank-k tail alpha * A * B + beta * C for a short contraction
// (k = a.shape[1] below 128), its product at a precision tier:
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
// Bound on an H100: bytes at large m and n (the arithmetic intensity of
// 2mnk flops over (mk + kn + 2mn) * 4 bytes stays below the FP32 ridge of
// ~20 flops/byte for k < 128 unless m and n are large), and latency at the
// band LU's [32, 96] x [96, 96], which is one dependent launch in a loop of
// 171. Design: a tiled SIMT product whose C tile is chosen by shape.
//   * Small outputs (fewer than ~one 64x64 tile per SM) take 16 x 32 tiles
//     of 128 threads, one row and four adjacent columns a thread: the
//     band LU's [32, 96] runs on 6 CTAs, none of them computing rows
//     beyond m.
//   * Larger ones take 64 x 64 tiles of 256 threads, a 4 x 4 micro-tile a
//     thread (rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3, each step of
//     k two float4 shared loads for 16 FMAs), so C is read once and the
//     output written once, as float4 where aligned.
// Every CTA issues a round of loads before it uses any of them: its C
// entries go to registers first, then the A strip [TM, k] and B strip
// [k, TN] are read into registers in unrolled rounds of KS contraction
// rows (float4 where the pointer and the leading dimension are 16-byte
// aligned, scalar otherwise; the chunk indices are compile-time shifts,
// no run-time division) and stored to shared memory (A transposed). The
// small tile takes any k <= 127 in one round. The large one takes rounds
// of 64: one at k <= 64, two above. Registers for all 128 rows in one
// round made it 0.133 ms against 0.103 at [4096, 64] x [64, 4096] (H100
// 80GB HBM3, 700 W; tools/tile_kernel_times.py). One accumulator per
// output, k ascending (fmaf), and the fused epilogue alpha * acc + beta *
// c with one rounding each: the bits of the one-tile-size kernel this
// replaces. No tensor cores: TF32 would keep 10 mantissa bits, below the
// bf16_6x tier's 2^-24 contract. The shared-memory limit of the large
// tile is set once per device, not at every launch.
//
// Tiers, as the Pallas kernel takes its caller's (trailing_dot_kwargs):
// with bf16 set (mxu_bf16) A and B are rounded to bf16, to nearest even,
// as they are stored to shared memory, and the same FP32 FMA loop runs
// on them (each product of two bf16 values is exact in FP32). bf16_3x
// and bf16_6x run the FP32 body: on CUDA cores a full FP32 product is the
// cheapest way to meet bf16_3x's 2^-18, since a split would only add
// passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 128;  // contraction rows staged (k <= 127)

inline bool aligned16(const float* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The [rows, cols] window of row-major g (leading dimension ld), rows <
// ROWS and cols < 4 * C4, into registers: chunk e = tid + u * NTH holds
// row e / C4 and columns 4 (e % C4) .. + 3, zero outside the window.
template <int ROWS, int C4, int NTH>
struct Strip {
  static constexpr int U = (ROWS * C4 + NTH - 1) / NTH;
  float4 v[U];

  __device__ __forceinline__ void fetch(const float* g, int ld, int rows, int cols,
                                        bool vec) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * NTH, r = e / C4, c = (e % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < ROWS * C4 && r < rows && c < cols) {
        const float* p = g + static_cast<size_t>(r) * ld + c;
        if (vec && c + 3 < cols) {
          x = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          x.x = __ldg(p);
          if (c + 1 < cols) x.y = __ldg(p + 1);
          if (c + 2 < cols) x.z = __ldg(p + 2);
          if (c + 3 < cols) x.w = __ldg(p + 3);
        }
      }
      v[u] = x;
    }
  }

  // s[r * ps + c] = window (r, c), or with TRANS s[c * ps + r], for the
  // chunks with r < rmax and c < cmax; with BF16 each value rounded to
  // bf16 (to nearest even) on the way
  template <bool TRANS, bool BF16>
  __device__ __forceinline__ void stash(float* s, int ps, int rmax, int cmax) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * NTH, r = e / C4, c = (e % C4) * 4;
      if (e >= ROWS * C4 || r >= rmax || c >= cmax) continue;
      float4 x = v[u];
      if (BF16) {
        x.x = __bfloat162float(__float2bfloat16_rn(x.x));
        x.y = __bfloat162float(__float2bfloat16_rn(x.y));
        x.z = __bfloat162float(__float2bfloat16_rn(x.z));
        x.w = __bfloat162float(__float2bfloat16_rn(x.w));
      }
      if (TRANS) {
        s[(c + 0) * ps + r] = x.x;
        s[(c + 1) * ps + r] = x.y;
        s[(c + 2) * ps + r] = x.z;
        s[(c + 3) * ps + r] = x.w;
      } else {
        *reinterpret_cast<float4*>(s + r * ps + c) = x;
      }
    }
  }
};

// One TM x TN tile of the output per CTA, NTH threads in a TY x TX grid,
// each RM adjacent rows (RM ty ..) by four adjacent columns (4 tx ..).
template <int TM, int TN, int RM>
struct Tile {
  static constexpr int TX = TN / 4, TY = TM / RM, NTH = TX * TY;
  // A strip pitch (transposed): read as float4 when a thread has 4 rows
  static constexpr int AP = RM == 4 ? TM + 4 : TM + 1;
  static size_t smem(int k) {
    return static_cast<size_t>((k + 3) & ~3) * (AP + TN) * sizeof(float);
  }
};

// KS: contraction rows staged a round; BF16: operands rounded to bf16
template <int TM, int TN, int RM, int KS, bool BF16>
__global__ void __launch_bounds__(Tile<TM, TN, RM>::NTH)
rank_k(const float* __restrict__ c, int ldc, const float* __restrict__ a, int lda,
       const float* __restrict__ b, int ldb, float* __restrict__ out, int m, int n,
       int k, float alpha, float beta, int vec_a, int vec_b, int vec_c, int vec_o) {
  static_assert(RM == 1 || RM == 4, "a thread takes one row or four");
  using P = Tile<TM, TN, RM>;
  extern __shared__ float4 sm4[];
  // As [k4][AP]: As[kk * AP + i] = A[i0 + i][kk]; Bs [k][TN]: Bs[kk * TN + j] =
  // B[kk][j0 + j]; k4 = k rounded up to 4 (A's last chunk)
  const int k4 = (k + 3) & ~3;
  float* As = reinterpret_cast<float*>(sm4);
  float* Bs = As + k4 * P::AP;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int tx = threadIdx.x % P::TX, ty = threadIdx.x / P::TX;
  const int jc = j0 + 4 * tx;

  // C first: its loads fly while the strips are fetched
  float4 cv[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + RM * ty + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < m && jc < n) {
      const float* p = c + static_cast<size_t>(i) * ldc + jc;
      if (vec_c && jc + 3 < n) {
        x = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        x.x = __ldg(p);
        if (jc + 1 < n) x.y = __ldg(p + 1);
        if (jc + 2 < n) x.z = __ldg(p + 2);
        if (jc + 3 < n) x.w = __ldg(p + 3);
      }
    }
    cv[r] = x;
  }
  for (int k0 = 0; k0 < k; k0 += KS) {
    const int kr = min(KS, k - k0);
    Strip<TM, KS / 4, P::NTH> sa;
    Strip<KS, TN / 4, P::NTH> sb;
    sa.fetch(a + static_cast<size_t>(i0) * lda + k0, lda, m - i0, kr, vec_a != 0);
    sb.fetch(b + static_cast<size_t>(k0) * ldb + j0, ldb, kr, n - j0, vec_b != 0);
    sa.template stash<true, BF16>(As + k0 * P::AP, P::AP, TM, kr);
    sb.template stash<false, BF16>(Bs + k0 * TN, TN, kr, TN);
  }
  __syncthreads();

  float acc[RM][4] = {};
  for (int kk = 0; kk < k; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * TN + 4 * tx);
    float av[RM];
    if constexpr (RM == 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * P::AP + RM * ty);
      av[0] = a4.x;
      av[1] = a4.y;
      av[2] = a4.z;
      av[3] = a4.w;
    } else {
      av[0] = As[kk * P::AP + ty];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      acc[r][0] = fmaf(av[r], bv.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], bv.y, acc[r][1]);
      acc[r][2] = fmaf(av[r], bv.z, acc[r][2]);
      acc[r][3] = fmaf(av[r], bv.w, acc[r][3]);
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + RM * ty + r;
    if (i >= m || jc >= n) continue;
    const float cs[4] = {cv[r].x, cv[r].y, cv[r].z, cv[r].w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = __fadd_rn(__fmul_rn(alpha, acc[r][q]), __fmul_rn(beta, cs[q]));
    float* p = out + static_cast<size_t>(i) * n + jc;
    if (vec_o && jc + 3 < n) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (jc + q < n) p[q] = o[q];
    }
  }
}

using Small = Tile<16, 32, 1>;
using Large = Tile<64, 64, 4>;
constexpr int MAX_DEVICES = 64;

// The large tile's shared memory is above the 48 KB default: raise the
// limit once for each device this process launches on (both roundings).
cudaError_t large_smem_once() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
  const int bytes = static_cast<int>(Large::smem(KMAX));
  e = cudaFuncSetAttribute(rank_k<64, 64, 4, 64, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rank_k<64, 64, 4, 64, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <bool BF16>
void launch(const float* c, int ldc, const float* a, int lda, const float* b, int ldb,
            float* out, int m, int n, int k, float alpha, float beta, int vec_a, int vec_b,
            int vec_c, int vec_o, bool large, cudaStream_t st) {
  if (!large) {
    const dim3 grid((n + 31) / 32, (m + 15) / 16);
    rank_k<16, 32, 1, KMAX, BF16><<<grid, Small::NTH, Small::smem(k), st>>>(
        c, ldc, a, lda, b, ldb, out, m, n, k, alpha, beta, vec_a, vec_b, vec_c, vec_o);
  } else {
    const dim3 grid((n + 63) / 64, (m + 63) / 64);
    rank_k<64, 64, 4, 64, BF16><<<grid, Large::NTH, Large::smem(k), st>>>(
        c, ldc, a, lda, b, ldb, out, m, n, k, alpha, beta, vec_a, vec_b, vec_c, vec_o);
  }
}

}  // namespace

// c: [m, n] (row stride ldc), a: [m, k] (lda), b: [k, n] (ldb), each with a
// unit column stride; out: [m, n] contiguous, not aliasing c; bf16 != 0
// rounds A and B to bf16 (the mxu_bf16 tier). Returns a CUDA error code (0
// on success); k outside 1..127 returns an error without launching.
extern "C" int slate_rank_k_tail_f32(const float* c, int ldc, const float* a, int lda,
                                     const float* b, int ldb, float* out, int m, int n,
                                     int k, float alpha, float beta, int bf16,
                                     void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 1 || k > 127) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec_a = aligned16(a) && lda % 4 == 0, vec_b = aligned16(b) && ldb % 4 == 0;
  const int vec_c = aligned16(c) && ldc % 4 == 0, vec_o = aligned16(out) && n % 4 == 0;
  const long long large_tiles = static_cast<long long>((m + 63) / 64) * ((n + 63) / 64);
  const bool large = large_tiles >= 128;
  if (large) {
    const cudaError_t e = large_smem_once();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (bf16)
    launch<true>(c, ldc, a, lda, b, ldb, out, m, n, k, alpha, beta, vec_a, vec_b, vec_c,
                 vec_o, large, st);
  else
    launch<false>(c, ldc, a, lda, b, ldb, out, m, n, k, alpha, beta, vec_a, vec_b, vec_c,
                  vec_o, large, st);
  return static_cast<int>(cudaGetLastError());
}
