// K2: triangular solve against a lower FP32 factor L [n, n] (n <= 1024), in
// place on X [m, n]:
//   slate_trsm_right_lower_t_f32   X = B * L^-T
//
// Replaces trsm_right_lower_t_pallas (slate_tpu/internal/pallas_kernels.py),
// the potrf panel solve: B is the panel below a diagonal tile, m = 1024 ...
// 15360 rows on posv at n = 1024. Per 64-column block c of X,
//   X[:, c] = (B[:, c] - X[:, <c] * L[c, <c]^T) * inv(L[c, c])^T,
// the Pallas kernel's algorithm, with the diagonal inverses by recursive
// doubling (dataflow.cuh) as in K1 and K3. Note X^T = L^-1 * B^T: this is
// K3's function on the transposed operand, m wide instead of 8.
//
// Bound on an H100: FP32 operations, m n^2 FMAs on the CUDA cores (the
// precision policy pins solves to full FP32: no TF32); 16.1 GFLOP, 0.24 ms
// at [15360, 1024]. What the card must be given is that work at every m:
// a design with one CTA per block of rows has m / 64 CTAs and walks the
// whole chain of n / 64 blocks on each, so below m = 8192 most SMs idle.
//
// Design: one cooperative launch, K3's dataflow form over X's tiles. The
// tasks are, in this order, the n / 64 inverses of L's diagonal blocks
// (each published once to global scratch behind a ready flag: recomputing
// one in every tile task would cost (m / BM) times as many), then the tiles
// (row block r of BM rows, column block c), column block by column block.
// A tile task starts from B[r, c] in registers, subtracts X[r, k] *
// L[c, k]^T for k < c as each X[r, k]'s ready flag shows it, multiplies by
// inv(L[c, c])^T and publishes X[r, c] with a release flag. So a small m
// still gives (m / BM) (n / 64) tasks, the chain of a block row is n / 64
// short steps (a flag, one BM x 64 x 64 product, the inverse's product),
// and a task waits only on earlier tasks of a co-resident grid: no
// deadlock. BM is 64 up to m = 4096 (twice the tasks, a shorter product on
// the chain) and 128 above (each L tile read feeds twice the rows); the
// switch point is measured (PERF.md section 6, PR 8).
// The products keep an RM x 4 register tile a thread (RM = BM / 16: 8 x 4
// at BM = 128), read their operands from shared memory as float4 along
// the contraction (12 shared loads per 128 FMAs), and stage the next X
// and L tiles with cp.async (L2 only: X is written by other SMs) into a
// second buffer while the current pair is multiplied, as soon as the next
// tile's flag is up. No integer division in any per-element loop. Widths
// that are not a multiple of 4, or a factor not 16-byte aligned, take
// plain L2 loads in place of cp.async.

#include "dataflow.cuh"

namespace {

using namespace slate::df;

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// s[i * PL + k] = g[i * ld + k] for i < rows, k < cols, zero elsewhere in
// the ROWS x 64 tile. VEC: cp.async of 16 bytes (cols % 4 == 0, g 16-byte
// aligned), in flight until cp_wait; else L2 loads, done on return.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(float* s, const float* g, size_t ld, int rows, int cols) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < ROWS * 16 / NTH; ++q) {
      const int idx = threadIdx.x + q * NTH, i = idx >> 4, k = (idx & 15) << 2;
      const bool ok = i < rows && k < cols;
      cp16(s + i * PL + k, ok ? g + i * ld + k : g, ok);
    }
  } else {
#pragma unroll
    for (int h = 0; h < ROWS; h += BT) load_cg(s + h * PL, PL, g + h * ld, ld, rows - h, cols);
  }
}

// acc[r][c] += SIGN * sum_k a[ty + 16r][k] * b[tx + 16c][k] over the 64 k,
// a and b of pitch PL, read as float4 along k.
template <int RM, int SIGN>
__device__ __forceinline__ void prod(const float* a, const float* b, float acc[RM][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int k = 0; k < BT; k += 4) {
    float4 av[RM], bv[4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty + 16 * r) * PL + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * PL + k);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float4 x = SIGN > 0 ? av[r] : make_float4(-av[r].x, -av[r].y, -av[r].z, -av[r].w);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(x.x, bv[c].x, s);
        s = fmaf(x.y, bv[c].y, s);
        s = fmaf(x.z, bv[c].z, s);
        s = fmaf(x.w, bv[c].w, s);
        acc[r][c] = s;
      }
    }
  }
}

// Whether the flag has reached `epoch`, as thread 0 reads it, for the
// whole CTA (a block barrier passes thread 0's acquire on).
__device__ __forceinline__ bool poll(const unsigned* f, unsigned epoch, int* s_flag) {
  if (threadIdx.x == 0) *s_flag = reached(f, epoch);
  __syncthreads();
  return *s_flag != 0;
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(NTH, 2)
dataflow_trsm_right(const float* __restrict__ l, float* x, float* dinv, int m, int n,
                    int unit, unsigned* flags, unsigned epoch) {
  constexpr int RM = BM / 16;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // two stages of an X tile (BM x 64) and an L tile (64 x 64); stage s at
  // sa(s), sb(s)
  const auto sa = [sm](int s) { return sm + s * BM * PL; };
  const auto sb = [sm](int s) { return sm + 2 * BM * PL + s * BT * PL; };
  __shared__ int s_flag;
  const int NC = (n + BT - 1) / BT, RB = (m + BM - 1) / BM;
  unsigned* dflag = flags;       // NC flags: inv(L[c, c]) published
  unsigned* xflag = flags + NC;  // NC * RB flags: X[r, c] published (c * RB + r)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int t = blockIdx.x; t < NC + NC * RB; t += gridDim.x) {
    if (t < NC) {
      // inv(L[c, c]) into dinv[c] (64 x 64, identity beyond the width)
      const int c0 = t * BT, w = min(BT, n - c0);
      load_cg(sa(0), PL, l + static_cast<size_t>(c0) * n + c0, n, w, w);
      __syncthreads();
      inv_lower(sa(0), PL, sb(0), PL, sb(1), w, unit != 0);
      float* d = dinv + static_cast<size_t>(t) * BT * BT;
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH)
        d[idx] = sb(0)[(idx >> 6) * PL + (idx & 63)];
      publish(dflag + t, epoch);
      continue;
    }
    const int tt = t - NC, c = tt / RB, r = tt - c * RB;
    const int r0 = r * BM, c0 = c * BT;
    const int hr = min(BM, m - r0), wc = min(BT, n - c0);
    float* xr = x + static_cast<size_t>(r0) * n;
    const float* lr = l + static_cast<size_t>(c0) * n;

    // B[r, c], read once, off the chain
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = ty + 16 * i, kk = tx + 16 * j;
        acc[i][j] = (ii < hr && kk < wc) ? __ldcg(xr + static_cast<size_t>(ii) * n + c0 + kk) : 0.f;
      }

    // minus X[r, k] * L[c, k]^T for k < c, each pair staged while the one
    // before is multiplied
    if (c > 0) {
      wait2(xflag + r, nullptr, epoch);
      load_tile<BM, VEC>(sa(0), xr, n, hr, BT);
      load_tile<BT, VEC>(sb(0), lr, n, wc, BT);
      cp_commit();
      for (int k = 0; k < c; ++k) {
        const int s = k & 1;
        const bool more = k + 1 < c;
        const bool pre = more && poll(xflag + (k + 1) * RB + r, epoch, &s_flag);
        if (pre) {
          load_tile<BM, VEC>(sa(s ^ 1), xr + (k + 1) * BT, n, hr, BT);
          load_tile<BT, VEC>(sb(s ^ 1), lr + (k + 1) * BT, n, wc, BT);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        prod<RM, -1>(sa(s), sb(s), acc);
        __syncthreads();
        if (more && !pre) {
          wait2(xflag + (k + 1) * RB + r, nullptr, epoch);
          load_tile<BM, VEC>(sa(s ^ 1), xr + (k + 1) * BT, n, hr, BT);
          load_tile<BT, VEC>(sb(s ^ 1), lr + (k + 1) * BT, n, wc, BT);
          cp_commit();
        }
      }
    }

    // X[r, c] = S * inv(L[c, c])^T with S = B[r, c] - sum in shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sa(0)[(ty + 16 * i) * PL + tx + 16 * j] = acc[i][j];
    wait2(dflag + c, nullptr, epoch);
    load_tile<BT, VEC>(sb(0), dinv + static_cast<size_t>(c) * BT * BT, BT, BT, BT);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float out[RM][4] = {};
    prod<RM, 1>(sa(0), sb(0), out);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = ty + 16 * i, kk = tx + 16 * j;
        if (ii < hr && kk < wc) xr[static_cast<size_t>(ii) * n + c0 + kk] = out[i][j];
      }
    publish(xflag + tt, epoch);
  }
}

template <int BM, bool VEC>
int launch(const float* l, float* x, float* dinv, int m, int n, int unit, unsigned* flags,
           unsigned epoch, cudaStream_t stream) {
  const size_t smem = (2 * BM + 2 * BT) * PL * sizeof(float);
  int cap = 0;
  cudaError_t e = coresident(dataflow_trsm_right<BM, VEC>, smem, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (n + BT - 1) / BT;
  const int tasks = nc + nc * ((m + BM - 1) / BM);
  const int G = tasks < cap ? tasks : cap;
  void* args[] = {&l, &x, &dinv, &m, &n, &unit, &flags, &epoch};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dataflow_trsm_right<BM, VEC>), dim3(G),
                                  dim3(NTH), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Most rows a launch splits into 64-row blocks; a taller B takes 128.
constexpr int NARROW_MAX = 4096;

}  // namespace

// l: [n, n] row-major, lower triangle read. x: [m, n] row-major, holds B on
// entry and X on exit. dinv: ceil(n / 64) * 64 * 64 floats of scratch.
// flags: ceil(n / 64) * (1 + ceil(m / 64)) ready flags whose values are all
// behind `epoch`. Returns a CUDA error code (0 on success).
extern "C" int slate_trsm_right_lower_t_f32(const float* l, float* x, float* dinv, int m, int n,
                                            int unit, unsigned* flags, unsigned epoch,
                                            void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (n > 16 * BT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<size_t>(l) % 16 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0;
  if (m <= NARROW_MAX)
    return vec ? launch<64, true>(l, x, dinv, m, n, unit, flags, epoch, s)
               : launch<64, false>(l, x, dinv, m, n, unit, flags, epoch, s);
  return vec ? launch<128, true>(l, x, dinv, m, n, unit, flags, epoch, s)
             : launch<128, false>(l, x, dinv, m, n, unit, flags, epoch, s);
}
