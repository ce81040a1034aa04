// K7: unpivoted LU of one [nb, nb] FP32 tile (nb <= 1024), in place,
// compact unit-L/U.
//
// Replaces lu_nopiv_tile_pallas (slate_tpu/internal/pallas_kernels.py),
// which keeps the whole tile in VMEM and walks it in column blocks. On the
// H100 the work (2 nb^3 / 3 flops, 11 microseconds of the card's FP32 rate
// at nb = 1024) is not the bound: the chain of 16 dependent diagonal
// blocks is. A host loop over the blocks puts four launches and a one-CTA
// diagonal factor with serial inverses on that chain per block.
//
// Design, K1's (potrf_tile.cu): one cooperative launch, a left-looking
// (Crout) tile algorithm driven by data. The tile stays in global memory
// (4 MB at nb = 1024, resident in L2). Its 64x64 tiles (i, k) are tasks,
// taken step by step in a fixed order (step s = min(i, k): the diagonal
// task, then the tasks of its L column and U row, interleaved) by a grid
// no larger than what is co-resident, so every task waits only on earlier
// tasks. Task (i, k) sums L[i, j] * U[j, k] over j < min(i, k), each
// product as soon as the ready flags of its two tiles show them; then
//   i == k: factors A[k, k] minus the sum in shared memory (16-column
//           panels, each by one warp in registers, then the panel's U rows
//           and the trailing block), and inverts its unit L and its safe U
//           (the transpose of a lower block) together into a scratch slot:
//           16x16 diagonal blocks by one warp each, then two levels of
//           recursive doubling;
//   i >  k: L[i, k] = (A[i, k] - sum) * U[k, k]^-1, one product;
//   i <  k: U[i, k] = L[i, i]^-1 * (A[i, k] - sum), one product.
// The chain per step is one diagonal task and one L or U task, with no
// launch and no grid barrier on it; the other products overlap it.
// A zero pivot keeps its 0 on the U diagonal; the elimination and the U
// inverse use 1 in its place (the Pallas kernel's safe diagonal), so the
// caller counts zero pivots off the result's diagonal. Math is FP32 FMAs
// on the CUDA cores (the precision policy pins tile factors to full FP32).

#include "dataflow.cuh"

namespace {

using namespace slate::df;

constexpr int PS = BT + 1;  // pitch of the diagonal block: column walks hit 32 banks
constexpr int CP = 16;      // panel width of the diagonal block's factor

// The reciprocal of a pivot, 1 in place of a zero one.
__device__ __forceinline__ float safe_rcp(float d) { return __frcp_rn(d == 0.f ? 1.f : d); }

// Columns p .. p+15 of the 64x64 block s (pitch PS, zero outside the
// tile), rows p .. 63, factored right-looking by one warp in registers:
// lane l holds rows p+l and p+l+32; a column step is a shuffle of the
// pivot, one reciprocal, the multipliers and shuffles of the pivot row
// for the update inside the panel. No block barrier inside the panel.
__device__ void lu_panel(float* s, int p) {
  const int lane = threadIdx.x % 32, r0 = p + lane, r1 = p + lane + 32;
  float a0[CP], a1[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    a0[c] = s[r0 * PS + p + c];
    a1[c] = r1 < BT ? s[r1 * PS + p + c] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float rp = safe_rcp(__shfl_sync(0xffffffffu, a0[j], j));
    const float l0 = a0[j] * rp, l1 = a1[j] * rp;
#pragma unroll
    for (int k = j + 1; k < CP; ++k) {
      const float uk = __shfl_sync(0xffffffffu, a0[k], j);
      if (lane > j) a0[k] = fmaf(-l0, uk, a0[k]);
      a1[k] = fmaf(-l1, uk, a1[k]);
    }
    if (lane > j) a0[j] = l0;
    a1[j] = l1;
  }
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    s[r0 * PS + p + c] = a0[c];
    if (r1 < BT) s[r1 * PS + p + c] = a1[c];
  }
}

// In-place unpivoted LU of the 64x64 block s (pitch PS; zero outside the
// w x w tile, whose zero pivots then take the safe 1) in 16-column
// panels: the panel by one warp (lu_panel); its U rows right of it,
// U12 = L11^-1 * A12, a column a thread down a 16-step chain; then the
// trailing block minus L21 * U12. Ends with a block barrier.
__device__ void lu_block(float* s) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int p = 0; p < BT; p += CP) {
    const int e = p + CP;
    if (threadIdx.x < 32) lu_panel(s, p);
    __syncthreads();
    if (e == BT) break;
    const int c = e + threadIdx.x;
    if (c < BT) {
      float x[CP];
#pragma unroll
      for (int r = 0; r < CP; ++r) x[r] = s[(p + r) * PS + c];
#pragma unroll
      for (int q = 0; q < CP; ++q)
#pragma unroll
        for (int r = q + 1; r < CP; ++r) x[r] = fmaf(-s[(p + r) * PS + p + q], x[q], x[r]);
#pragma unroll
      for (int r = 1; r < CP; ++r) s[(p + r) * PS + c] = x[r];
    }
    __syncthreads();
    // the trailing block minus L21 * U12: a 4x4 micro-tile a thread, the
    // panel's 16 terms in order (whole-tile products; the masked entries
    // are dropped)
    float acc[4][4] = {};
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      float lv[4], uv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lv[r] = s[(ty + 16 * r) * PS + p + q];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) uv[cc] = s[(p + q) * PS + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(lv[r], uv[cc], acc[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ty + 16 * r, k = tx + 16 * cc;
        if (i >= e && k >= e) s[i * PS + k] -= acc[r][cc];
      }
    __syncthreads();
  }
}

// Entry (r, c), r > c, of the two lower-triangular blocks that lu_block's
// result s holds: m = 0 the unit L, m = 1 the transpose of U.
__device__ __forceinline__ float tri(const float* s, int m, int r, int c) {
  return m == 0 ? s[r * PS + c] : s[c * PS + r];
}

// The inverses of the unit L and of the safe U of the factored block s
// (pitch PS; zero outside the tile, so the padding inverts to the
// identity): L^-1 into v0 and (U^-1)^T, the inverse of the lower block U^T,
// into v1 (pitch PL). First each 16x16 diagonal block of both, one warp
// each in registers (a column a lane, by substitution); then two levels of
// recursive doubling, 16 -> 32 and 32 -> 64: for [[A, 0], [C, D]] whose
// halves are inverted, the lower-left block -D^-1 * (C * A^-1), 4 or 8
// outputs a thread sharing their loads. w_scr holds 2048 floats (16-byte
// aligned). Ends with a block barrier.
__device__ void inv_lu(const float* s, float* v0, float* v1, float* w_scr) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int idx = t; idx < BT * BT; idx += NTH) {
    v0[(idx / BT) * PL + idx % BT] = 0.f;
    v1[(idx / BT) * PL + idx % BT] = 0.f;
  }
  __syncthreads();
  {
    const int m = warp / 4, b = 16 * (warp % 4), c = lane;
    float* v = m == 0 ? v0 : v1;
    if (c < 16) {
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = i == c ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (m == 1) {
          const float d = s[(b + k) * PS + b + k];
          x[k] = x[k] * (1.f / (d == 0.f ? 1.f : d));
        }
#pragma unroll
        for (int i = k + 1; i < 16; ++i) x[i] = fmaf(-tri(s, m, b + i, b + k), x[k], x[i]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) v[(b + i) * PL + b + c] = x[i];
    }
  }
  __syncthreads();
  // 16 -> 32: combo = (m, p) for the 32-blocks at p = 0, 32; 16 rows x 4
  // column groups of 4 a combo
  {
    const int combo = t / 64, e = t % 64, m = combo / 2, p = 32 * (combo % 2);
    const int r = e / 4, c4 = 4 * (e % 4);
    float* v = m == 0 ? v0 : v1;
    float* wc = w_scr + combo * 256;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float cv = tri(s, m, p + 16 + r, p + q);
      const float4 a = *reinterpret_cast<const float4*>(v + (p + q) * PL + p + c4);
      acc.x = fmaf(cv, a.x, acc.x);
      acc.y = fmaf(cv, a.y, acc.y);
      acc.z = fmaf(cv, a.z, acc.z);
      acc.w = fmaf(cv, a.w, acc.w);
    }
    *reinterpret_cast<float4*>(wc + r * 16 + c4) = acc;
    __syncthreads();
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float dv = v[(p + 16 + r) * PL + p + 16 + q];
      const float4 wv = *reinterpret_cast<const float4*>(wc + q * 16 + c4);
      acc.x = fmaf(dv, wv.x, acc.x);
      acc.y = fmaf(dv, wv.y, acc.y);
      acc.z = fmaf(dv, wv.z, acc.z);
      acc.w = fmaf(dv, wv.w, acc.w);
    }
    *reinterpret_cast<float4*>(v + (p + 16 + r) * PL + p + c4) =
        make_float4(-acc.x, -acc.y, -acc.z, -acc.w);
  }
  __syncthreads();
  // 32 -> 64: one combo a matrix, 32 rows x 4 column groups of 8
  {
    const int m = t / 128, e = t % 128, r = e / 4, c8 = 8 * (e % 4);
    float* v = m == 0 ? v0 : v1;
    float* wc = w_scr + m * 1024;
    float acc[8] = {};
#pragma unroll 8
    for (int q = 0; q < 32; ++q) {
      const float cv = tri(s, m, 32 + r, q);
      const float4 a0 = *reinterpret_cast<const float4*>(v + q * PL + c8);
      const float4 a1 = *reinterpret_cast<const float4*>(v + q * PL + c8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = fmaf(cv, a[u], acc[u]);
    }
    *reinterpret_cast<float4*>(wc + r * 32 + c8) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(wc + r * 32 + c8 + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = 0.f;
#pragma unroll 8
    for (int q = 0; q < 32; ++q) {
      const float dv = v[(32 + r) * PL + 32 + q];
      const float4 w0 = *reinterpret_cast<const float4*>(wc + q * 32 + c8);
      const float4 w1 = *reinterpret_cast<const float4*>(wc + q * 32 + c8 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = fmaf(dv, wv[u], acc[u]);
    }
    *reinterpret_cast<float4*>(v + (32 + r) * PL + c8) =
        make_float4(-acc[0], -acc[1], -acc[2], -acc[3]);
    *reinterpret_cast<float4*>(v + (32 + r) * PL + c8 + 4) =
        make_float4(-acc[4], -acc[5], -acc[6], -acc[7]);
  }
  __syncthreads();
}

// s[k * ps + i] = v[q] for this thread's entries (i, k) of fetch: the
// tile transposed.
__device__ __forceinline__ void stash_t(float* s, int ps, const float v[PER]) {
  const int i0 = threadIdx.x / BT, k = threadIdx.x % BT;
#pragma unroll
  for (int q = 0; q < PER; ++q) s[k * ps + i0 + q * (NTH / BT)] = v[q];
}

__global__ void __launch_bounds__(NTH)
dataflow_lu_nopiv_tile(float* a, int nb, float* inv, unsigned* flags, unsigned epoch) {
  extern __shared__ float4 smem4[];
  float* pa = reinterpret_cast<float*>(smem4);  // 64 x PL
  float* pb = pa + BT * PL;                      // 64 x PL
  float* sd = pb + BT * PL;                      // 64 x PS
  float* wscr = sd + BT * PS;                    // 2048 (16-byte aligned)
  __shared__ bool s_next;
  const int nt = (nb + BT - 1) / BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // task (i, k): step s = min(i, k) starts at s * (2 nt - s); within it the
  // diagonal, then (s + d, s) and (s, s + d) for d = 1, 2, ...
  auto task = [nt](int i, int k) {
    const int s = min(i, k), d = max(i, k) - s;
    return s * (2 * nt - s) + (d == 0 ? 0 : 2 * d - (i > k ? 1 : 0));
  };

  for (int t = blockIdx.x; t < nt * nt; t += gridDim.x) {
    int s = 0;
    while (t >= (s + 1) * (2 * nt - s - 1)) ++s;
    const int off = t - s * (2 * nt - s), d = (off + 1) / 2;
    const int i = (off & 1) ? s + d : s, k = (off & 1) || off == 0 ? s : s + d;
    const int r0 = i * BT, c0 = k * BT;
    const int hi = min(BT, nb - r0), wk = min(BT, nb - c0);
    float* tile = a + static_cast<size_t>(r0) * nb + c0;
    // the task's own tile of A, read before the chain reaches it
    float own[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = ty + 16 * r, kk = tx + 16 * c;
        own[r][c] = (ii < hi && kk < wk) ? __ldcg(tile + static_cast<size_t>(ii) * nb + kk) : 0.f;
      }

    // sum_j L[i, j] * U[j, k]: L[i, j] as it lies, U[j, k] transposed, so
    // the product is A * B^T; the tiles of step j + 1 are fetched during
    // step j's product when their flags are already up
    float acc[4][4] = {};
    float va[PER], vb[PER];
    const float* gi = a + static_cast<size_t>(r0) * nb;
    const float* gk = a + c0;
    const int m = min(i, k);
    bool have = false;
    for (int j = 0; j < m; ++j) {
      if (!have) {
        wait2(flags + task(i, j), flags + task(j, k), epoch);
        fetch(va, gi + j * BT, nb, hi, BT);
        fetch(vb, gk + static_cast<size_t>(j) * BT * nb, nb, BT, wk);
      }
      stash(pa, PL, va);
      stash_t(pb, PL, vb);
      if (threadIdx.x == 0)
        s_next = j + 1 < m && reached(flags + task(i, j + 1), epoch) &&
                 reached(flags + task(j + 1, k), epoch);
      __syncthreads();
      have = s_next;
      if (have) {
        fetch(va, gi + (j + 1) * BT, nb, hi, BT);
        fetch(vb, gk + static_cast<size_t>(j + 1) * BT * nb, nb, BT, wk);
      }
      prod_abt(pa, pb, acc);
      __syncthreads();
    }

    if (i == k) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sd[(ty + 16 * r) * PS + tx + 16 * c] = own[r][c] - acc[r][c];
      __syncthreads();
      lu_block(sd);
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH) {
        const int ii = idx / BT, kk = idx % BT;
        if (ii < wk && kk < wk) tile[static_cast<size_t>(ii) * nb + kk] = sd[ii * PS + kk];
      }
      inv_lu(sd, pa, pb, wscr);
      float* slot = inv + static_cast<size_t>(k) * 2 * BT * BT;
      for (int idx = threadIdx.x; idx < BT * BT; idx += NTH) {
        slot[idx] = pa[(idx / BT) * PL + idx % BT];
        slot[BT * BT + idx] = pb[(idx / BT) * PL + idx % BT];
      }
    } else {
      // X = A - sum: as it lies into pa for L, transposed into pb for U
      float* x = i > k ? pa : pb;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = ty + 16 * r, kk = tx + 16 * c;
          x[i > k ? ii * PL + kk : kk * PL + ii] = own[r][c] - acc[r][c];
        }
      wait2(flags + task(m, m), nullptr, epoch);
      // L: X * U^-1 = A * B^T with B = (U^-1)^T; U: L^-1 * X, B = X^T
      if (i > k)
        load_cg(pb, PL, inv + (static_cast<size_t>(k) * 2 + 1) * BT * BT, BT, BT, BT);
      else
        load_cg(pa, PL, inv + static_cast<size_t>(i) * 2 * BT * BT, BT, BT, BT);
      __syncthreads();
      float out[4][4] = {};
      prod_abt(pa, pb, out);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = ty + 16 * r, kk = tx + 16 * c;
          if (ii < hi && kk < wk) tile[static_cast<size_t>(ii) * nb + kk] = out[r][c];
        }
    }
    publish(flags + t, epoch);
  }
}

}  // namespace

// a: [nb, nb] row-major FP32 on the device, factored in place.
// inv: ceil(nb / 64) * 2 * 64 * 64 floats of scratch (each diagonal
// block's L^-1 and (U^-1)^T). flags: ceil(nb / 64)^2 ready flags whose
// values are all behind `epoch`. Launches on `stream`; returns the CUDA
// error of the launch (0 on success).
extern "C" int slate_lu_nopiv_tile_f32(float* a, int nb, float* inv, unsigned* flags,
                                       unsigned epoch, void* stream) {
  if (nb <= 0) return 0;
  const size_t smem = (2 * BT * PL + BT * PS + 2048) * sizeof(float);
  int cap = 0;
  cudaError_t e = coresident(dataflow_lu_nopiv_tile, smem, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (nb + BT - 1) / BT, tasks = nt * nt;
  const int G = tasks < cap ? tasks : cap;
  void* args[] = {&a, &nb, &inv, &flags, &epoch};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dataflow_lu_nopiv_tile), dim3(G),
                                  dim3(NTH), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
