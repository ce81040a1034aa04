// Partial-pivot LU of a rows-at-origin [h, w] panel with physical row
// swaps, in FP32:
//   slate_panel_plu_swap_f32
//
// Replaces _panel_plu_kernel behind panel_plu_pallas
// (slate_tpu/internal/pallas_kernels.py:464-529), Aasen's panel (hetrf step
// 5 through tile_kernels.panel_lu_factor). It factors x = a[h][w] (row-major,
// in place) column by column, for j < min(h, w):
//   score_i = |x[i][j]| for positions i >= j, -1 above; r = the lowest
//     position whose score equals the maximum (LAPACK isamax: the tie goes to
//     the current position, after the earlier swaps). A NaN score makes the
//     maximum NaN, no score equals it, and r = h: nothing is selected;
//   rowr = x[r] (zeros when r = h), rowj = x[j]; x[j] = rowr, x[r] = rowj:
//     whole rows move, the L columns already factored included;
//   pv = rowr[j] (0 when r = h); info += (pv == 0); safe = pv, or 1 if 0;
//   l_i = x[i][j] / safe for i > j, 0 for i <= j; u_k = rowr[k] for k > j,
//     0 for k <= j; x[i][k] -= l_i * u_k for every i and k, then
//     x[i][j] = l_i for i > j; piv[j] = r.
// The full rank-1 update is the JAX kernel's; it changes an entry off the
// block x[j+1:, j+1:] only through IEEE arithmetic on a non-finite factor
// (l_i * 0 or 0 * u_k is NaN when l_i or u_k is infinite or NaN), so the
// kernel updates that block and writes NaN where such a product is NaN.
// Products and differences are rounded one at a time (no FMA contraction)
// and the multipliers are true divisions, as the plain PyTorch version
// computes them.
//
// Bound on an H100: latency. The bytes (2 h w 4: 33 MB at [16128, 256]) and
// flops (h w^2) are tens of microseconds; the w dependent column steps each
// need a reduction over all h rows and a row exchange between two CTAs.
// One cooperative launch with one CTA per SM; each CTA holds its band of R
// consecutive positions (<= 123 x 256 f32 = 126 KB at h = 16128) in shared
// memory for the whole call, column-major with an odd pitch so that walks
// along a row and along a column are both free of bank conflicts.
//
// Design. A column step's chain is: the CTAs' local searches of column j,
// the exchange of candidates through L2, the winner row, the multipliers,
// and the update of column j + 1, which the next search reads. The rest of
// the rank-1 update is taken off that chain:
//   * Columns go in blocks of IB = 32. A step updates only the block's own
//     columns; the update of the trailing columns is deferred to the end
//     of the block, where every CTA applies the block's IB rank-1 updates
//     to its rows from registers, in the same order with the same
//     roundings, so every entry receives the same sequence of x - l * u as
//     in the column loop. The pivot rows' trailing parts (the u of each
//     step) come from the same sequential updates, which every CTA forms
//     from the block's pivot rows that it keeps in shared memory. The NaN
//     rules touch only entries that no later step of the block reads, so
//     they are replayed at the block's end too.
//   * No grid barrier and no memory fence: each CTA publishes its
//     candidate (score, position and a tag naming the column, one 64-bit
//     word) as soon as its search ends, then the candidate's row (and the
//     holder of position j row j) with the tag beside every element, and
//     waits for the G words of the column; a reader takes a row element
//     once it carries the column's tag. A CTA forms its multipliers and
//     column j + 1 in one pass with the search of column j + 1, publishes,
//     and only then updates the block's other columns while the other CTAs
//     arrive. The published rows are exact at once: their block columns
//     get that last update as they are written. Words and rows live in
//     zeroed global scratch double-buffered by column parity; a slot of
//     parity j % 2 is rewritten at column j + 2 only after its writer has
//     seen the words of column j + 1, which every CTA publishes after it
//     has read column j's slots (a newer tag never satisfies a reader, so
//     a broken order would trap rather than pass).
//   * No integer division in any per-entry loop.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int WMAX = 256;     // widest panel
constexpr int NTH = 512;      // threads per CTA
constexpr int NW = NTH / 32;  // warps per CTA
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds (keeps small h on few CTAs)
constexpr int IB = 32;        // columns per block of deferred trailing updates
constexpr int QMAX = 8;       // candidate words one lane reads: a grid of <= 256 CTAs
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ULL;
constexpr unsigned NO_POS = 0xFFFFu;  // a CTA without a position >= j

// A candidate's rank as one 64-bit key, larger is better: a NaN score
// first, then the larger score (|x| >= 0, whose bits order as unsigned
// integers), then the lower position; a CTA without a position >= j (score
// -inf) ranks below every candidate.
__device__ __forceinline__ unsigned score_rank(float s) {
  return isnan(s) ? 0xFFFFFFFFu : (s == -INFINITY ? 0u : __float_as_uint(s) + 1u);
}

__device__ __forceinline__ unsigned long long key(unsigned rank, unsigned pos) {
  return (static_cast<unsigned long long>(rank) << 32) | (0xFFFFFFFFu - pos);
}

// The largest key of the warp, in two warp reductions.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32), lo = static_cast<unsigned>(k);
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}

__device__ __forceinline__ unsigned key_pos(unsigned long long k) {
  return 0xFFFFFFFFu - static_cast<unsigned>(k);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Spin guard: a wait longer than this is taken for a broken protocol and
// traps (a launch error for the caller) rather than hanging the card.
__device__ __forceinline__ void guard(unsigned long long& t0) {
  const unsigned long long t = now_ns();
  if (t0 == 0) t0 = t;
  if (t - t0 > WAIT_LIMIT_NS) __trap();
}

// A candidate word: the score's rank, the column's tag (j + 1) and the
// position (NO_POS for a CTA without one).
__device__ __forceinline__ unsigned long long pack(unsigned long long k, int tag) {
  const unsigned rank = static_cast<unsigned>(k >> 32);
  const unsigned p = rank == 0 ? NO_POS : key_pos(k);
  return (static_cast<unsigned long long>(rank) << 32) | (static_cast<unsigned>(tag) << 16) | p;
}

// A published row element: the value's bits and the column's tag.
__device__ __forceinline__ unsigned long long tagged(float v, unsigned tag) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) | tag;
}

// The value of the published row element v read from p, once it carries
// `tag` (read again until it does).
__device__ __forceinline__ float untag(unsigned long long v, const unsigned long long* p,
                                       unsigned tag) {
  unsigned long long t0 = 0;
  while (static_cast<unsigned>(v) != tag) {
    guard(t0);
    v = ld_relaxed(p);
  }
  return __uint_as_float(static_cast<unsigned>(v >> 32));
}

__device__ __forceinline__ float fms(float x, float l, float u) {
  return __fsub_rn(x, __fmul_rn(l, u));
}

struct Ctx {
  float* sx;  // [w][P]: sx[c * P + i] = x[r0 + i][c]
  float* ub;  // [IB][w]: the pivot rows of the current block, as each step read them
  unsigned long long* cand;
  unsigned long long* cand_row;
  unsigned long long* row_j;
  int g, G, r0, nr, w, P;
  unsigned long long* red;  // [NW]
  int* s_loc;
};

// Column jn's candidate from this thread's key kb: the CTA's best of its
// positions >= jn, published as one word at once, then that row and (from
// the holder of position jn) row jn, each element tagged. With fly, the
// rows get the rank-1 update of step jn - 1 (block row jbp of ub) on the
// block columns (jn, jc) as they are written: that part of the update is
// still pending in sx. Ends with a block barrier.
__device__ void publish(const Ctx& c, int jn, unsigned long long kb, bool fly, int jbp, int jc) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = (jn & 1) * c.G;
  const unsigned tag = static_cast<unsigned>(jn + 1);
  kb = warp_max(kb);
  if (lane == 0) c.red[warp] = kb;
  __syncthreads();
  if (warp == 0) {
    kb = warp_max(lane < NW ? c.red[lane] : 0ull);
    if (lane == 0) {
      *c.s_loc = kb >> 32 == 0 ? -1 : static_cast<int>(key_pos(kb)) - c.r0;
      st_relaxed(c.cand + slot + c.g, pack(kb, jn + 1));
    }
  }
  __syncthreads();
  auto put = [&](unsigned long long* dst, int i) {
    const float l = fly ? c.sx[(jn - 1) * c.P + i] : 0.f;
    for (int k = tid; k < c.w; k += NTH) {
      float v = c.sx[k * c.P + i];
      if (fly && k > jn && k < jc) v = fms(v, l, c.ub[jbp * c.w + k]);
      st_relaxed(dst + k, tagged(v, tag));
    }
  };
  if (*c.s_loc >= 0) put(c.cand_row + static_cast<size_t>(slot + c.g) * c.w, *c.s_loc);
  if (jn >= c.r0 && jn < c.r0 + c.nr) put(c.row_j + (jn & 1) * c.w, jn - c.r0);
  __syncthreads();
}

// This thread's best key over its positions >= jn in column jn.
__device__ __forceinline__ unsigned long long local_best(const Ctx& c, int jn) {
  unsigned long long kb = 0;
  for (int i = max(0, jn - c.r0) + threadIdx.x; i < c.nr; i += NTH) {
    const unsigned long long k = key(score_rank(fabsf(c.sx[jn * c.P + i])), c.r0 + i);
    kb = k > kb ? k : kb;
  }
  return kb;
}

// Warp 0 waits for the G candidate words of column j and reduces them in
// one total order (a NaN first, then the larger score, then the lower
// position), so every CTA finds the same winner. The loads of a lane are
// all in flight at once.
__device__ void wait_winner(const Ctx& c, int j, unsigned long long* s_win) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  const unsigned long long* words = c.cand + (j & 1) * c.G;
  const unsigned tag = static_cast<unsigned>(j + 1);
  unsigned long long wv[QMAX];
  unsigned pending = 0;
#pragma unroll
  for (int u = 0; u < QMAX; ++u)
    if (lane + 32 * u < c.G) pending |= 1u << u;
  unsigned long long t0 = 0;
  while (true) {
#pragma unroll
    for (int u = 0; u < QMAX; ++u)
      if (pending >> u & 1) wv[u] = ld_relaxed(words + lane + 32 * u);
#pragma unroll
    for (int u = 0; u < QMAX; ++u)
      if ((pending >> u & 1) && ((static_cast<unsigned>(wv[u]) >> 16) & 0xFFFFu) == tag)
        pending &= ~(1u << u);
    if (!__any_sync(0xffffffffu, pending != 0)) break;
    guard(t0);
  }
  unsigned long long kb = 0;
#pragma unroll
  for (int u = 0; u < QMAX; ++u)
    if (lane + 32 * u < c.G) {
      const unsigned rank = static_cast<unsigned>(wv[u] >> 32);
      const unsigned long long k =
          rank == 0 ? 0ull : key(rank, static_cast<unsigned>(wv[u]) & 0xFFFFu);
      kb = k > kb ? k : kb;
    }
  kb = warp_max(kb);
  if (lane == 0) *s_win = kb;
}

__global__ void __launch_bounds__(NTH)
plu_swap(float* __restrict__ a, int* __restrict__ piv, int* __restrict__ info,
         unsigned long long* cand, unsigned long long* cand_row, unsigned long long* row_j, int h,
         int w, int R, int P) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ unsigned long long red[NW], s_win;
  __shared__ int s_loc, s_bad;
  __shared__ bool s_none[IB];
  __shared__ int s_tl[WMAX];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  Ctx c;
  c.sx = sm;
  c.ub = sm + w * P;
  c.cand = cand;
  c.cand_row = cand_row;
  c.row_j = row_j;
  c.g = blockIdx.x;
  c.G = gridDim.x;
  c.r0 = c.g * R;
  c.nr = min(R, h - c.r0);
  c.w = w;
  c.P = P;
  c.red = red;
  c.s_loc = &s_loc;
  float* sx = c.sx;
  float* ub = c.ub;
  const int r0 = c.r0, nr = c.nr;

  for (int i = warp; i < nr; i += NW)
    for (int k = lane; k < w; k += 32) sx[k * P + i] = a[static_cast<size_t>(r0 + i) * w + k];
  __syncthreads();

  int zeros = 0;
  const int kmax = min(h, w);
  publish(c, 0, local_best(c, 0), false, 0, 0);
  for (int j0 = 0; j0 < kmax; j0 += IB) {
    // steps j0 .. je-1 (fewer than IB only in the last block of a panel
    // shorter than wide); columns j0 .. jc-1 are updated step by step, the
    // trailing ones at the block's end
    const int je = min(j0 + IB, kmax), nbk = je - j0, jc = j0 + IB;
    if (tid == 0) s_bad = 0;
    for (int j = j0; j < je; ++j) {
      const int jb = j - j0;
      const unsigned tag = static_cast<unsigned>(j + 1);
      wait_winner(c, j, &s_win);
      __syncthreads();
      // the winner row, and the exchange: rowr into position j, rowj into
      // position r (a NaN score selects no row)
      const bool none = s_win >> 32 == 0xFFFFFFFFull;
      const int wr = static_cast<int>(key_pos(s_win));
      const bool hold_j = j >= r0 && j < r0 + nr;
      const bool hold_r = !none && wr != j && wr >= r0 && wr < r0 + nr;
      const unsigned long long* src =
          cand_row + static_cast<size_t>((j & 1) * c.G + (none ? 0 : wr / R)) * w;
      float* u = ub + jb * w;
      const unsigned long long* rj = row_j + (j & 1) * w;
      for (int k = tid; k < w; k += NTH) {
        // both loads in flight before either is waited on
        const unsigned long long e = none ? 0ull : ld_relaxed(src + k);
        const unsigned long long f = hold_r ? ld_relaxed(rj + k) : 0ull;
        const float v = none ? 0.f : untag(e, src + k, tag);
        u[k] = v;
        if (k > j && !isfinite(v)) s_bad = 1;
        if (hold_j) sx[k * P + (j - r0)] = v;
        if (hold_r) sx[k * P + (wr - r0)] = untag(f, rj + k, tag);
      }
      if (tid == 0) {
        s_none[jb] = none;
        if (c.g == 0) piv[j] = none ? h : wr;
      }
      __syncthreads();
      const float pv = u[j];
      const float safe = pv == 0.f ? 1.f : pv;
      if (tid == 0) zeros += pv == 0.f;
      // the multipliers of the positions below j; inside the block also
      // column j + 1, which the next search reads, and that search
      const int ilo = max(0, j + 1 - r0);
      if (j + 1 < je) {
        const float u1 = u[j + 1];
        unsigned long long kb = 0;
        for (int i = ilo + tid; i < nr; i += NTH) {
          const float l = __fdiv_rn(sx[j * P + i], safe);
          const float x1 = fms(sx[(j + 1) * P + i], l, u1);
          sx[j * P + i] = l;
          sx[(j + 1) * P + i] = x1;
          const unsigned long long k = key(score_rank(fabsf(x1)), r0 + i);
          kb = k > kb ? k : kb;
        }
        publish(c, j + 1, kb, true, jb, jc);
        // the block's other columns, while the other CTAs arrive
        for (int k = j + 2 + warp; k < jc; k += NW) {
          const float uk = u[k];
          for (int i = ilo + lane; i < nr; i += 32) sx[k * P + i] = fms(sx[k * P + i], sx[j * P + i], uk);
        }
      } else {
        for (int i = ilo + tid; i < nr; i += NTH) sx[j * P + i] = __fdiv_rn(sx[j * P + i], safe);
      }
    }
    __syncthreads();

    // End of the block. The pivot rows' trailing parts: row t gets the
    // updates of steps j0 .. t-1 in order (a step without a pivot has
    // u = 0), one column a thread. A block of fewer than IB steps (the last
    // one of a panel shorter than wide) computes its unused rows from stale
    // data that reach no used row, and stores zeros there for the update
    // below.
    for (int k = jc + tid; k < w; k += NTH) {
      float x[IB];
#pragma unroll
      for (int t = 0; t < IB; ++t) x[t] = ub[t * w + k];
#pragma unroll
      for (int q = 0; q < IB; ++q) {
        if (s_none[q]) x[q] = 0.f;
#pragma unroll
        for (int t = q + 1; t < IB; ++t) x[t] = fms(x[t], ub[t * w + j0 + q], x[q]);
      }
      bool bad = false;
#pragma unroll
      for (int t = 0; t < IB; ++t) {
        ub[t * w + k] = t < nbk ? x[t] : 0.f;
        bad |= t < nbk && !isfinite(x[t]);
      }
      if (bad) s_bad = 1;
    }
    __syncthreads();
    // The trailing columns of this CTA's rows: positions >= je take the
    // block's updates from registers (its multipliers l, the pivot rows'
    // u, four columns at a time), the block's pivot positions take their
    // rows' parts just formed, positions above j0 keep theirs.
    const int ngrp = (nr + 31) / 32;
    const int wpg = NW / ngrp;
    if (warp < ngrp * wpg) {
      const int grp = warp % ngrp, part = warp / ngrp;
      const int i = grp * 32 + lane, p = r0 + i;
      if (i < nr && p >= j0) {
        if (p >= je) {
          // l = 0 and u = 0 beyond nbk: x - 0 * 0 is x
          float l[IB];
#pragma unroll
          for (int t = 0; t < IB; ++t) l[t] = t < nbk ? sx[(j0 + t) * P + i] : 0.f;
          for (int k = jc + 4 * part; k < w; k += 4 * wpg) {
            float x0 = sx[k * P + i], x1 = sx[(k + 1) * P + i];
            float x2 = sx[(k + 2) * P + i], x3 = sx[(k + 3) * P + i];
#pragma unroll
            for (int t = 0; t < IB; ++t) {
              const float4 uv = *reinterpret_cast<const float4*>(ub + t * w + k);
              x0 = fms(x0, l[t], uv.x);
              x1 = fms(x1, l[t], uv.y);
              x2 = fms(x2, l[t], uv.z);
              x3 = fms(x3, l[t], uv.w);
            }
            sx[k * P + i] = x0;
            sx[(k + 1) * P + i] = x1;
            sx[(k + 2) * P + i] = x2;
            sx[(k + 3) * P + i] = x3;
          }
        } else {
          for (int k = jc + part; k < w; k += wpg) sx[k * P + i] = ub[(p - j0) * w + k];
        }
      }
    }
    __syncthreads();
    // The NaN rules of the block's steps. A row whose multiplier l of step
    // t is not finite gets NaN in every column left of t; a row at a
    // position <= t gets NaN in each column k > t where u_t[k] is not
    // finite (the pivot row itself included).
    for (int i = tid; i < nr; i += NTH) {
      const int p = r0 + i;
      int tmax = -1;
      for (int t = j0; t < min(p, je); ++t)
        if (!isfinite(sx[t * P + i])) tmax = t;
      for (int k = 0; k < tmax; ++k) sx[k * P + i] = NAN;
    }
    if (s_bad) {
      for (int k = tid; k < w; k += NTH) {
        int tl = -1;
        for (int t = j0; t < min(je, k); ++t)
          if (!isfinite(ub[(t - j0) * w + k])) tl = t;
        s_tl[k] = tl;
      }
      __syncthreads();
      for (int k = warp; k < w; k += NW)
        for (int i = lane; i < nr; i += 32)
          if (r0 + i <= s_tl[k]) sx[k * P + i] = NAN;
    }
    __syncthreads();
    if (je < kmax) publish(c, je, local_best(c, je), false, 0, 0);
  }

  if (c.g == 0 && tid == 0) *info = zeros;
  __syncthreads();
  for (int i = warp; i < nr; i += NW)
    for (int k = lane; k < w; k += 32) a[static_cast<size_t>(r0 + i) * w + k] = sx[k * P + i];
}

}  // namespace

// a: [h, w] row-major, factored in place; piv: [min(h, w)] int32; info: [1]
// int32. Scratch from the caller, zeroed: cand holds 2 * max_ctas 64-bit
// words, cand_row 2 * max_ctas * w, row_j 2 * w. Returns a CUDA
// error code (0 on success); a panel wider than 256 or not a multiple of
// 32 wide, a band of rows that does not fit one SM's shared memory, or a
// grid that cannot be co-resident returns an error without launching.
extern "C" int slate_panel_plu_swap_f32(float* a, int* piv, int* info, unsigned long long* cand,
                                        unsigned long long* cand_row, unsigned long long* row_j,
                                        int max_ctas, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (w > WMAX || w % IB != 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int R = (h + sms - 1) / sms;
  if (R < MIN_ROWS) R = MIN_ROWS;
  const int G = (h + R - 1) / R;
  if (G > max_ctas || G > 32 * QMAX || R > 32 * NW) return static_cast<int>(cudaErrorInvalidValue);
  const int P = R | 1;  // odd pitch: row and column walks are conflict-free
  const size_t smem = (static_cast<size_t>(w) * P + static_cast<size_t>(IB) * w) * sizeof(float);
  if (smem + 4096 > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(plu_swap, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plu_swap, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a, &piv, &info, &cand, &cand_row, &row_j, &h, &w, &R, const_cast<int*>(&P)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(plu_swap), dim3(G), dim3(NTH), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
