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
// window of the dense matrix in place, and unfold_panel and the back
// transpose_tiled write into one (the wrapper's destination).
//
// Bound by bytes: each element read once and written once, no arithmetic
// (at [16384, 1024], 128 MiB in all: 0.040 ms at 3.35 TB/s). Design for the
// H100:
// * A 64x64 tile (16 KB) goes through shared memory. The fill reads it row
//   by row with 16-byte cp.async copies (a warp reads two 256-byte row
//   segments); the drain gives each thread one 4x4 block: four 16-byte
//   shared reads down the rows, a transpose in registers, four 16-byte
//   stores, so a warp writes two 256-byte segments of y's rows.
// * The tile is stored in 16-byte chunks, chunk c4 of row r at position
//   c4 ^ ((r / 4) % 8) of its row. The fill's eight threads of a quarter
//   warp write eight chunks of one row, and the drain's read eight chunks
//   of one column from rows 4 apart: both hit eight distinct 4-bank groups,
//   so neither conflicts.
// * Each CTA takes two tiles, a grid stride apart, and keeps the second
//   tile's copies in flight while it drains the first (two buffers,
//   cp.async groups); the card holds five such CTAs an SM (44 registers a
//   thread, 32 KB), up to 160 KB of reads in flight an SM. A grid of the
//   CTAs that fit, each walking many tiles, was 5-7% slower at [16384,
//   1024], one tile a CTA no faster (tools/kernel_split.py --only k5).
// * At [16384, 1024] it takes about 50.7 us against a contiguous copy of
//   the same bytes at 49.2 us (Tensor.copy_) and an empty launch at 4.7
//   us, timed alike (PERF.md section 6): the pass runs at the card's copy
//   rate, and the rest to the byte bound is the launch and what HBM gives
//   a mix of reads and writes.
// * The 16-byte path needs 16-byte aligned segments and row strides that
//   are multiples of 4 floats, on each side separately. Elsewhere (an odd
//   window, the ragged edge of R or C), the same loop copies and stores
//   element by element under a mask, so any R, C >= 1 and any strides go
//   through this kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TR = 64;                 // tile rows (x's rows, y's columns)
constexpr int TC = 64;                 // tile columns (x's columns, y's rows)
constexpr int CH = TC / 4;             // 16-byte chunks in a tile row
constexpr int NT = (TR / 4) * (TC / 4);  // threads: one 4x4 block each
constexpr int STAGES = 2;              // tiles in shared memory at once
constexpr int PER_CTA = 2;             // tiles a CTA takes
constexpr int FILL = TR * CH / NT;     // chunks each thread copies a tile

static_assert(TR * CH % NT == 0, "the fill splits evenly");

__device__ __forceinline__ int swz(int r) { return (r >> 2) & 7; }

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Tile {
  int s, r0, c0;
};

__device__ __forceinline__ Tile tile_at(int t, int tr, int tc) {
  const int per = tr * tc;
  const int s = t / per, q = t - s * per;
  const int rt = q / tc;
  return {s, rt * TR, (q - rt * tc) * TC};
}

// Issue the copies of one tile into buffer b (no wait).
__device__ __forceinline__ void fill(float4* b, const float* x, Tile tl, int R,
                                     int C, long long xr, long long xb,
                                     bool vx) {
  const float* xs = x + tl.s * xb;
#pragma unroll
  for (int k = 0; k < FILL; ++k) {
    const int q = threadIdx.x + k * NT;
    const int rr = q / CH, cc = q % CH;
    const int r = tl.r0 + rr, c = tl.c0 + 4 * cc;
    if (r >= R) continue;
    float4* dst = b + rr * CH + (cc ^ swz(rr));
    const float* src = xs + r * xr + c;
    if (vx && c + 3 < C) {
      cp_async16(dst, src);
    } else {
      float* d = reinterpret_cast<float*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < C) cp_async4(d + e, src + e);
    }
  }
}

// Store the transpose of buffer b's tile: this thread's 4x4 block.
__device__ __forceinline__ void drain(const float4* b, float* y, Tile tl, int R,
                                      int C, long long yr, long long yb,
                                      bool vy) {
  const int r4 = threadIdx.x % (TR / 4), c4 = threadIdx.x / (TR / 4);
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = b[(4 * r4 + k) * CH + (c4 ^ (r4 & 7))];
  const float o[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x},
                         {v[0].y, v[1].y, v[2].y, v[3].y},
                         {v[0].z, v[1].z, v[2].z, v[3].z},
                         {v[0].w, v[1].w, v[2].w, v[3].w}};
  const int r = tl.r0 + 4 * r4;
  float* ys = y + tl.s * yb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tl.c0 + 4 * c4 + j;
    if (c >= C || r >= R) continue;
    float* dst = ys + c * yr + r;
    if (vy && r + 3 < R) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[j][0], o[j][1], o[j][2],
                                                    o[j][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r + k < R) dst[k] = o[j][k];
    }
  }
}

__global__ void __launch_bounds__(NT)
panel_transpose(const float* __restrict__ x, float* __restrict__ y, int S, int R,
                int C, long long xr, long long xb, long long yr, long long yb,
                bool vx, bool vy) {
  __shared__ float4 buf[STAGES][TR * CH];
  const int tr = (R + TR - 1) / TR, tc = (C + TC - 1) / TC;
  const int total = S * tr * tc;
  const int G = gridDim.x;
  // prologue: the first STAGES - 1 tiles in flight
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    const int t = blockIdx.x + p * G;
    if (t < total) fill(buf[p], x, tile_at(t, tr, tc), R, C, xr, xb, vx);
    cp_async_commit();
  }
  int i = 0;
  for (int t = blockIdx.x; t < total; t += G, ++i) {
    const int tn = t + (STAGES - 1) * G;
    if (tn < total)
      fill(buf[(i + STAGES - 1) % STAGES], x, tile_at(tn, tr, tc), R, C, xr, xb,
           vx);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this thread's copies of tile t landed
    __syncthreads();               // and every thread's
    drain(buf[i % STAGES], y, tile_at(t, tr, tc), R, C, yr, yb, vy);
    __syncthreads();               // buffer i % STAGES is free again
  }
}

bool aligned16(const void* p, long long rs, long long ss, int S) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 && rs % 4 == 0 &&
         (S == 1 || ss % 4 == 0);
}

}  // namespace

// Returns the CUDA launch error (0 on success).
extern "C" int slate_panel_transpose_f32(const float* x, float* y, int S, int R, int C,
                                         long long xr, long long xb, long long yr,
                                         long long yb, void* stream) {
  if (S <= 0 || R <= 0 || C <= 0) return 0;
  const long long total =
      static_cast<long long>(S) * ((R + TR - 1) / TR) * ((C + TC - 1) / TC);
  const int grid = static_cast<int>((total + PER_CTA - 1) / PER_CTA);
  panel_transpose<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, S, R, C, xr, xb, yr, yb, aligned16(x, xr, xb, S),
      aligned16(y, yr, yb, S));
  return static_cast<int>(cudaGetLastError());
}
