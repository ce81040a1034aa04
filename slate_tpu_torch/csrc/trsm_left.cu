// K3: X = L^-1 * B against a lower FP32 factor L [n, n] (n <= 1024), in
// place on X [n, m].
//
// Replaces trsm_left_lower_pallas (slate_tpu/internal/pallas_kernels.py),
// the forward solve of one diagonal tile against a block row. On its
// callers B is thin (m = nrhs = 8; L is [1024, 1024] in posv, gesv and
// gesv_nopiv, [256, 256] in hesv), so the work is tiny (n^2 m FMAs, a few
// microseconds of the card's FP32 rate) and reading L (2 MB of its lower
// half at n = 1024) is the bound; what costs time is the chain of n/64
// dependent block rows. A design whose CTAs run over B's columns puts all
// of that chain on one CTA for m <= 64.
//
// Design: a cooperative grid of CTAs that take tasks (block row r, column
// block c) of 64 rows by CB columns, column block by column block, row
// block by row block. CB is 8 for m <= 128: a thin B gets up to 16
// column tasks per block row, each step of its chain a short product.
// Above, CB is 64: with 8-column tasks every block row's diagonal inverse
// would be recomputed m/8 times and the tasks would outnumber the
// co-resident grid. The switch point is measured at n = 1024 on an H100
// 80GB HBM3 at 700 W (PERF.md section 6: 8-column tasks win at m = 128
// and lose at m = 256).
// A task first inverts its diagonal block L[r, r] (recursive doubling,
// dataflow.cuh); every CTA does so at once, off the chain. It then
// accumulates L[r, j] * X[j] for j < r, each X[j] as soon as its task's
// ready flag shows it, with L[r, j] loaded before the wait; solves its
// block as inv(L[r, r]) * (B[r] - sum); and publishes it with a release
// flag. The chain is n/64 short steps: a flag, one 64 x 64 x CB product and
// the inverse's product. For CB = 8 the 256 threads split each product's
// 64-long contraction into 8 slices whose partial sums meet in shared
// memory once per task, so a thin product is ~16 dependent FMAs a thread.
// The grid is no larger than what is co-resident, and a task waits only on
// tasks earlier in the order, which some running CTA holds or has done: no
// deadlock. Math is FP32 FMAs on the CUDA cores (the precision policy pins
// solves to full FP32: no TF32).

#include "dataflow.cuh"

namespace {

using namespace slate::df;

// Thread layout of a 64 x CB product: 64/CB groups along k, each of
// 4 * CB threads holding a 4 x 4 micro-tile, rows ry + 16r, columns
// 4cx .. 4cx + 3.
template <int CB>
struct Lay {
  static constexpr int XP = CB + 4;  // pitch of an X tile [64][CB]
  int g, ry, cx;
  __device__ Lay() {
    const int tt = threadIdx.x % (4 * CB);
    g = threadIdx.x / (4 * CB);
    ry = tt / (CB / 4);
    cx = tt % (CB / 4);
  }
};

// acc[r][c] += sum over this thread's k slice of a[ry + 16r][k] * x[k][4cx + c]
template <int CB>
__device__ __forceinline__ void prod_ax(const Lay<CB>& t, const float* a, const float* x,
                                        float acc[4][4]) {
  const int k0 = t.g * CB;
#pragma unroll 2
  for (int k = k0; k < k0 + CB; k += 4) {
    float4 av[4], xv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (t.ry + 16 * r) * PL + k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xv[q] = *reinterpret_cast<const float4*>(x + (k + q) * Lay<CB>::XP + 4 * t.cx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ar[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][0] = fmaf(ar[q], xv[q].x, acc[r][0]);
        acc[r][1] = fmaf(ar[q], xv[q].y, acc[r][1]);
        acc[r][2] = fmaf(ar[q], xv[q].z, acc[r][2]);
        acc[r][3] = fmaf(ar[q], xv[q].w, acc[r][3]);
      }
    }
  }
}

// Partial sums of the k groups to red[(g * 64 + row) * CB + col]; the sum
// of row i, column col is then sum_g red[...]. Ends with a block barrier.
template <int CB>
__device__ __forceinline__ void spill(const Lay<CB>& t, const float acc[4][4], float* red) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(t.g * BT + t.ry + 16 * r) * CB + 4 * t.cx + c] = acc[r][c];
  __syncthreads();
}

template <int CB>
__device__ __forceinline__ float gathered(const float* red, int i, int col) {
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < BT / CB; ++g) s += red[(g * BT + i) * CB + col];
  return s;
}

// Wide launches (CB = 64, up to 16 x ceil(m / 64) tasks) are capped at 128
// registers so that two CTAs fit an SM; the thin ones keep their registers.
template <int CB>
__global__ void __launch_bounds__(NTH, CB == 64 ? 2 : 1)
dataflow_trsm_left(const float* __restrict__ l, float* x, int n, int m, int unit, unsigned* flags,
          unsigned epoch) {
  constexpr int XP = Lay<CB>::XP;
  extern __shared__ float4 smem4[];
  float* dinv = reinterpret_cast<float*>(smem4);  // 64 x PL
  float* la = dinv + BT * PL;                      // 64 x PL
  float* xs = la + BT * PL;                        // 64 x XP
  float* red = xs + BT * XP;                       // 4096, also inv_lower's scratch
  const Lay<CB> lay;
  const int R = (n + BT - 1) / BT, C = (m + CB - 1) / CB;

  for (int t = blockIdx.x; t < R * C; t += gridDim.x) {
    const int c = t / R, r = t % R;
    const int r0 = r * BT, h = min(BT, n - r0);
    const int c0 = c * CB, w = min(CB, m - c0);

    load_cg(la, PL, l + static_cast<size_t>(r0) * n + r0, n, h, h);
    __syncthreads();
    inv_lower(la, PL, dinv, PL, red, h, unit != 0);

    // this thread's entries of B[r], read once, off the chain
    constexpr int NXB = BT * CB / NTH;  // entries of an X block a thread moves
    float* xr = x + static_cast<size_t>(r0) * m + c0;
    float bv[NXB];
#pragma unroll
    for (int q = 0; q < NXB; ++q) {
      const int idx = threadIdx.x + q * NTH, i = idx / CB, k = idx % CB;
      bv[q] = (i < h && k < w) ? __ldcg(xr + static_cast<size_t>(i) * m + k) : 0.f;
    }

    // L[r, j] does not wait on any flag: the next one is always in flight
    float acc[4][4] = {};
    float vl[PER];
    const float* lr = l + static_cast<size_t>(r0) * n;
    if (r > 0) fetch(vl, lr, n, h, BT);
    for (int j = 0; j < r; ++j) {
      stash(la, PL, vl);
      if (j + 1 < r) fetch(vl, lr + (j + 1) * BT, n, h, BT);
      wait2(flags + c * R + j, nullptr, epoch);
      const float* xj = x + static_cast<size_t>(j) * BT * m + c0;
      float v[NXB];
#pragma unroll
      for (int q = 0; q < NXB; ++q) {
        const int idx = threadIdx.x + q * NTH, k = idx % CB;
        v[q] = k < w ? __ldcg(xj + static_cast<size_t>(idx / CB) * m + k) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < NXB; ++q) {
        const int idx = threadIdx.x + q * NTH;
        xs[(idx / CB) * XP + idx % CB] = v[q];
      }
      __syncthreads();
      prod_ax<CB>(lay, la, xs, acc);
      __syncthreads();
    }

    // S = B[r] - sum into xs, then X[r] = inv(L[r, r]) * S
    spill<CB>(lay, acc, red);
#pragma unroll
    for (int q = 0; q < NXB; ++q) {
      const int idx = threadIdx.x + q * NTH, i = idx / CB, k = idx % CB;
      xs[i * XP + k] = (i < h && k < w) ? bv[q] - gathered<CB>(red, i, k) : 0.f;
    }
    __syncthreads();
    float out[4][4] = {};
    prod_ax<CB>(lay, dinv, xs, out);
    spill<CB>(lay, out, red);
    for (int idx = threadIdx.x; idx < BT * CB; idx += NTH) {
      const int i = idx / CB, k = idx % CB;
      if (i < h && k < w) xr[static_cast<size_t>(i) * m + k] = gathered<CB>(red, i, k);
    }
    publish(flags + t, epoch);
  }
}

template <int CB>
int launch(const float* l, float* x, int n, int m, int unit, unsigned* flags, unsigned epoch,
           cudaStream_t stream) {
  const size_t smem = (2 * BT * PL + BT * Lay<CB>::XP + 4096) * sizeof(float);
  int cap = 0;
  cudaError_t e = coresident(dataflow_trsm_left<CB>, smem, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tasks = ((n + BT - 1) / BT) * ((m + CB - 1) / CB);
  const int G = tasks < cap ? tasks : cap;
  void* args[] = {&l, &x, &n, &m, &unit, &flags, &epoch};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dataflow_trsm_left<CB>), dim3(G),
                                  dim3(NTH), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Most right-hand sides a launch splits into 8-column tasks; a wider B
// takes 64-column tasks.
constexpr int THIN_MAX = 128;

}  // namespace

// l: [n, n] row-major, lower triangle read. x: [n, m] row-major, holds B on
// entry and X on exit. flags: ceil(n / 64) * ceil(m / 8) ready flags
// whose values are all behind `epoch`. Returns a CUDA error code (0 on
// success).
extern "C" int slate_trsm_left_lower_f32(const float* l, float* x, int n, int m, int unit,
                                         unsigned* flags, unsigned epoch, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m <= THIN_MAX ? launch<8>(l, x, n, m, unit, flags, epoch, s)
                       : launch<64>(l, x, n, m, unit, flags, epoch, s);
}
