// Pivoted LU of one 128-column block of a segmented column-major panel,
// pivoting by index (rows are never moved), in FP32:
//   slate_plu_block_f32
//
// Replaces _plu_kernel / _plu_kernel_folded (slate_tpu/internal/panel_plu.py),
// which serve _plu_call (S = 1), _plu_call_folded and plu_call_folded_block
// (S = 8). The panel buffer is p[S][nb][L], h = S * L rows, row r at
// (r / L, r % L); column c of segment q is contiguous over l. The kernel
// factors columns blk*128 .. blk*128+127 in place against the activity mask
// act[h] (1 = row may still pivot), updated in place:
//   for j in 0..127:
//     pivot r = the active row with the largest |x[., j]|, lowest index on
//       ties; inactive rows score -1 (so with no active row the lowest row
//       is taken, and nothing is updated). A NaN among the active scores
//       selects no row: piv[j] = h, the mask is kept, and the pivot value
//       is NaN, so every active row turns NaN from column j on (the JAX
//       kernel's max-then-index-min does the same: mx is NaN, score >= mx
//       holds nowhere, min gives h);
//     info += (pivot value == 0); rsafe = 1 on a zero pivot, else 1/pivot;
//     act[r] = 0; each active row i: x[i][j] *= rsafe, then
//       x[i][k] -= x[r][k] * x[i][j] for k > j (a right-looking update).
//   Rows inactive on entry are never written.
// The JAX kernel's IB=8 delayed strip update and [8, 8] Neumann inverse only
// feed the MXU; the eager update is the same in exact arithmetic. Products
// and differences are rounded one at a time (no FMA contraction), as the
// plain PyTorch version computes them, so kernel and plain version agree
// bit for bit.
//
// Bound on an H100: neither bytes (2 h 128 4 B, 16.8 MB at h = 16384) nor
// operations (h 128^2 flops) but latency: 128 dependent steps, each a
// reduction over all h rows. One cooperative launch with one CTA per SM
// (the launch fails, never hangs, if the grid cannot be co-resident); each
// CTA keeps its R rows (<= 125 x 128 f32 at h = 16384) in shared memory
// for the whole call, column-major with an odd pitch.
//
// Design. A column step's chain is: the CTAs' local searches of column j,
// the exchange of candidates through L2, the winner row, the multipliers,
// and the update of column j + 1, which the next search reads. The rest of
// the rank-1 update is taken off that chain (csrc/panel_plu_swap.cu does
// the same for the physical-swap LU):
//   * Columns go in blocks of IB = 32. A step updates only the block's
//     columns; the trailing columns are updated at the block's end, where
//     every CTA gives each of its rows the block's updates of the steps at
//     which the row was still active, from registers, in the column loop's
//     order with the same roundings: every entry receives the same
//     sequence of x - l * u as in the column loop. The pivot rows' trailing
//     parts (the u of each step) come from the same sequential updates,
//     which every CTA forms from the block's pivot rows that it keeps in
//     shared memory (tests/test_torch_panel_plu_sched.py models this
//     schedule on the host and holds it to the plain version bit for bit).
//   * No grid barrier and no memory fence: each CTA publishes its
//     candidate (score rank, row and a tag naming the launch and the
//     column, one 64-bit word) as soon as its search ends, then the
//     candidate's row from the block's first column on, the tag beside
//     every element, and waits for the G words of the column; a reader
//     takes a row element once it carries the column's tag. The published
//     row is exact in the block's columns at once: they get the last
//     step's pending update as they are written. Words and rows live in
//     global scratch, double-buffered by column parity; a slot of parity
//     j % 2 is rewritten at column j + 2 only after its writer has seen
//     the words of column j + 1, which every CTA publishes after it has
//     read column j's slots.
//   * The multipliers, column j + 1 and the search of column j + 1 are one
//     pass over the CTA's rows; the block's other columns are updated
//     after the candidate is published, while the other CTAs arrive.
//   * The scratch is the caller's, kept from call to call: a tag carries
//     the launch's epoch (1 .. 255, the caller zeroes the scratch before
//     it wraps), so no word or element of an earlier launch satisfies a
//     reader, and no memset runs between launches.
//   * No integer division in any per-entry loop.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int W = 128;        // block width: columns factored per call
constexpr int NTH = 512;      // threads per CTA
constexpr int NW = NTH / 32;  // warps per CTA
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds (keeps small h on few CTAs)
constexpr int IB = 32;        // columns per block of deferred trailing updates
constexpr int QMAX = 8;       // candidate words one lane reads: a grid of <= 256 CTAs
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ULL;

// A candidate's rank as one 64-bit key, larger is better: a NaN score
// first, then the larger |x| (whose bits order as unsigned integers), then
// an inactive row (score -1); among equal ranks the lower row.
__device__ __forceinline__ unsigned score_rank(float x, bool active) {
  const float s = fabsf(x);
  return !active ? 0u : (isnan(s) ? 0xFFFFFFFFu : __float_as_uint(s) + 1u);
}

__device__ __forceinline__ unsigned long long key(unsigned rank, unsigned row) {
  return (static_cast<unsigned long long>(rank) << 32) | (0xFFFFFFFFu - row);
}

__device__ __forceinline__ unsigned key_row(unsigned long long k) {
  return 0xFFFFFFFFu - static_cast<unsigned>(k);
}

// The largest key of the warp, in two warp reductions.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32), lo = static_cast<unsigned>(k);
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
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

// The 16-bit tag of column j in the launch of this epoch.
__device__ __forceinline__ unsigned col_tag(unsigned epoch, int j) {
  return (epoch << 8) | static_cast<unsigned>(j + 1);
}

// A candidate word: the score's rank, the tag and the row.
__device__ __forceinline__ unsigned long long pack(unsigned long long k, unsigned tag) {
  return (k & 0xFFFFFFFF00000000ull) | (tag << 16) | key_row(k);
}

// A published row element: the value's bits and the tag.
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
  float* sx;    // [W][P]: sx[c * P + i] = x[r0 + i][c]
  float* ub;    // [IB][W]: the pivot rows of the current block, as each step read them
  float* sact;  // [R] the mask, updated
  unsigned long long* cand;
  unsigned long long* cand_row;
  int g, G, r0, nr, P;
  unsigned epoch;
  unsigned long long* red;  // [NW]
  int* s_loc;
};

// Column jn's candidate from this thread's key kb: the CTA's best row,
// published as one word at once, then that row from the block's first
// column on, each element tagged. With fly, an active row gets the rank-1
// update of step jn - 1 (block row jbp of ub) on the block columns (jn, jc)
// as it is written: that part of the update is still pending in sx. Ends
// with a block barrier.
__device__ void publish(const Ctx& c, int jn, unsigned long long kb, bool fly, int jbp) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = (jn & 1) * c.G;
  const unsigned tag = col_tag(c.epoch, jn);
  const int k0 = jn & ~(IB - 1), jc = k0 + IB;
  kb = warp_max(kb);
  if (lane == 0) c.red[warp] = kb;
  __syncthreads();
  if (warp == 0) {
    kb = warp_max(lane < NW ? c.red[lane] : 0ull);
    if (lane == 0) {
      *c.s_loc = static_cast<int>(key_row(kb)) - c.r0;
      st_relaxed(c.cand + slot + c.g, pack(kb, tag));
    }
  }
  __syncthreads();
  const int i = *c.s_loc;
  const bool on = fly && c.sact[i] > 0.f;
  const float l = on ? c.sx[(jn - 1) * c.P + i] : 0.f;
  unsigned long long* dst = c.cand_row + static_cast<size_t>(slot + c.g) * W;
  for (int k = k0 + tid; k < W; k += NTH) {
    float v = c.sx[k * c.P + i];
    if (on && k > jn && k < jc) v = fms(v, l, c.ub[jbp * W + k]);
    st_relaxed(dst + k, tagged(v, tag));
  }
  __syncthreads();
}

// This thread's best key over its rows in column jn.
__device__ __forceinline__ unsigned long long local_best(const Ctx& c, int jn) {
  unsigned long long kb = 0;
  for (int i = threadIdx.x; i < c.nr; i += NTH) {
    const unsigned long long k = key(score_rank(c.sx[jn * c.P + i], c.sact[i] > 0.f), c.r0 + i);
    kb = k > kb ? k : kb;
  }
  return kb;
}

// Warp 0 waits for the G candidate words of column j and reduces them in
// one total order, so every CTA finds the same winner. The loads of a lane
// are all in flight at once.
__device__ void wait_winner(const Ctx& c, int j, unsigned long long* s_win) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  const unsigned long long* words = c.cand + (j & 1) * c.G;
  const unsigned tag = col_tag(c.epoch, j);
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
      const unsigned long long k =
          key(static_cast<unsigned>(wv[u] >> 32), static_cast<unsigned>(wv[u]) & 0xFFFFu);
      kb = k > kb ? k : kb;
    }
  kb = warp_max(kb);
  if (lane == 0) *s_win = kb;
}

__global__ void __launch_bounds__(NTH)
plu_block(float* __restrict__ p, float* __restrict__ act, int* __restrict__ piv,
          int* __restrict__ info, unsigned long long* cand, unsigned long long* cand_row, int nb,
          int L, int blk, int R, int P, int h, unsigned epoch) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ unsigned long long red[NW], s_win;
  __shared__ int s_loc;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  Ctx c;
  c.sx = sm;
  c.ub = sm + W * P;
  c.sact = c.ub + IB * W;
  c.cand = cand;
  c.cand_row = cand_row;
  c.g = blockIdx.x;
  c.G = gridDim.x;
  c.r0 = c.g * R;
  c.nr = min(R, h - c.r0);
  c.P = P;
  c.epoch = epoch;
  c.red = red;
  c.s_loc = &s_loc;
  float* sx = c.sx;
  float* ub = c.ub;
  float* sact = c.sact;
  float* sact0 = sact + R;                                   // [R] mask on entry
  int* sdq = reinterpret_cast<int*>(sact0 + R);              // [R] updates due at block end
  unsigned* roff = reinterpret_cast<unsigned*>(sdq + R);     // [R] offset of row r0 + i
  const int r0 = c.r0, nr = c.nr;
  // the row-wise updates: ngrp groups of 32 rows, wpg warps a group
  const int ngrp = (nr + 31) / 32, wpg = NW / ngrp;
  const unsigned seg = static_cast<unsigned>(nb) * L;
  const unsigned col0 = static_cast<unsigned>(blk) * W;

  for (int i = tid; i < nr; i += NTH) {
    const int r = r0 + i;
    roff[i] = (r / L) * seg + r % L;
    sact[i] = sact0[i] = act[r];
  }
  __syncthreads();
  for (int k = warp; k < W; k += NW)
    for (int i = lane; i < nr; i += 32) sx[k * P + i] = p[roff[i] + (col0 + k) * L];
  __syncthreads();

  int zeros = 0;
  publish(c, 0, local_best(c, 0), false, 0);
  for (int j0 = 0; j0 < W; j0 += IB) {
    const int jc = j0 + IB;
    // updates each row takes at the block's end: all IB while it stays
    // active, those before its pivot step if it pivots, none if inactive
    for (int i = tid; i < nr; i += NTH) sdq[i] = sact[i] > 0.f ? IB : 0;
    for (int j = j0; j < jc; ++j) {
      const int jb = j - j0;
      const unsigned tag = col_tag(epoch, j);
      wait_winner(c, j, &s_win);
      __syncthreads();
      // the winner row from the block's first column (a NaN score selects
      // no row: u is NaN)
      const bool none = s_win >> 32 == 0xFFFFFFFFull;
      const int wr = static_cast<int>(key_row(s_win));
      const unsigned long long* src =
          cand_row + static_cast<size_t>((j & 1) * c.G + (none ? 0 : wr / R)) * W;
      float* u = ub + jb * W;
      for (int k = j0 + tid; k < W; k += NTH)
        u[k] = none ? NAN : untag(ld_relaxed(src + k), src + k, tag);
      if (tid == 0) {
        if (c.g == 0) piv[j] = none ? h : wr;
        if (!none && wr >= r0 && wr < r0 + nr) {
          // an inactive winner (no row is active) takes no update anyway
          if (sact[wr - r0] > 0.f) sdq[wr - r0] = jb;
          sact[wr - r0] = 0.f;
        }
      }
      __syncthreads();
      const float pv = u[j];
      const float rsafe = pv == 0.f ? 1.f : 1.f / pv;
      if (tid == 0) zeros += pv == 0.f;
      if (j + 1 < jc) {
        // the multipliers, column j + 1 and its search in one pass
        const float u1 = u[j + 1];
        unsigned long long kb = 0;
        for (int i = tid; i < nr; i += NTH) {
          const bool on = sact[i] > 0.f;
          float x1 = sx[(j + 1) * P + i];
          if (on) {
            const float l = __fmul_rn(sx[j * P + i], rsafe);
            sx[j * P + i] = l;
            x1 = fms(x1, l, u1);
            sx[(j + 1) * P + i] = x1;
          }
          const unsigned long long k = key(score_rank(x1, on), r0 + i);
          kb = k > kb ? k : kb;
        }
        publish(c, j + 1, kb, true, jb);
        // the block's other columns, while the other CTAs arrive: a row a
        // lane, its multiplier read once
        if (warp < ngrp * wpg) {
          const int i = (warp % ngrp) * 32 + lane;
          if (i < nr && sact[i] > 0.f) {
            const float l = sx[j * P + i];
            for (int k = j + 2 + warp / ngrp; k < jc; k += wpg)
              sx[k * P + i] = fms(sx[k * P + i], l, u[k]);
          }
        }
      } else {
        for (int i = tid; i < nr; i += NTH)
          if (sact[i] > 0.f) sx[j * P + i] = __fmul_rn(sx[j * P + i], rsafe);
      }
    }
    __syncthreads();
    if (jc == W) break;

    // End of the block. The pivot rows' trailing parts: row t gets the
    // updates of steps j0 .. t-1 in order, one column a thread. (A NaN
    // step's row is NaN; a step without an active row takes row 0, whose
    // part no active row ever reads.)
    for (int k = jc + tid; k < W; k += NTH) {
      float x[IB];
#pragma unroll
      for (int t = 0; t < IB; ++t) x[t] = ub[t * W + k];
#pragma unroll
      for (int q = 0; q < IB; ++q)
#pragma unroll
        for (int t = q + 1; t < IB; ++t) x[t] = fms(x[t], ub[t * W + j0 + q], x[q]);
#pragma unroll
      for (int t = 0; t < IB; ++t) ub[t * W + k] = x[t];
    }
    __syncthreads();
    // The trailing columns of this CTA's rows: row i takes the block's
    // first sdq[i] updates from registers (its multipliers l, the pivot
    // rows' u, four columns at a time).
    if (warp < ngrp * wpg) {
      const int grp = warp % ngrp, part = warp / ngrp;
      const int i = grp * 32 + lane;
      const int d = i < nr ? sdq[i] : 0;
      if (d > 0) {
        float l[IB];
#pragma unroll
        for (int t = 0; t < IB; ++t) l[t] = sx[(j0 + t) * P + i];
        for (int k = jc + 4 * part; k < W; k += 4 * wpg) {
          float x0 = sx[k * P + i], x1 = sx[(k + 1) * P + i];
          float x2 = sx[(k + 2) * P + i], x3 = sx[(k + 3) * P + i];
#pragma unroll
          for (int t = 0; t < IB; ++t) {
            const float4 uv = *reinterpret_cast<const float4*>(ub + t * W + k);
            const bool take = t < d;
            x0 = take ? fms(x0, l[t], uv.x) : x0;
            x1 = take ? fms(x1, l[t], uv.y) : x1;
            x2 = take ? fms(x2, l[t], uv.z) : x2;
            x3 = take ? fms(x3, l[t], uv.w) : x3;
          }
          sx[k * P + i] = x0;
          sx[(k + 1) * P + i] = x1;
          sx[(k + 2) * P + i] = x2;
          sx[(k + 3) * P + i] = x3;
        }
      }
    }
    __syncthreads();
    publish(c, jc, local_best(c, jc), false, 0);
  }

  if (c.g == 0 && tid == 0) *info = zeros;
  for (int k = warp; k < W; k += NW)
    for (int i = lane; i < nr; i += 32)
      if (sact0[i] > 0.f) p[roff[i] + (col0 + k) * L] = sx[k * P + i];
  for (int i = tid; i < nr; i += NTH) act[r0 + i] = sact[i];
}

}  // namespace

// p: [S, nb, L] contiguous; act: [S * L]; piv: [128] int32; info: [1] int32.
// scratch: 2 * max_ctas * 129 64-bit words kept by the caller from launch
// to launch, zeroed when first made and whenever the epoch (1 .. 255)
// wraps. Returns a CUDA error code (0 on success); a grid larger than
// max_ctas, rows that do not fit one SM's shared memory, or a grid that
// cannot be co-resident returns an error without launching.
extern "C" int slate_plu_block_f32(float* p, float* act, int* piv, int* info,
                                   unsigned long long* scratch, int max_ctas, int epoch, int S,
                                   int nb, int L, int blk, void* stream) {
  const int h = S * L;
  if (h <= 0) return 0;
  if (epoch < 1 || epoch > 255 || h > 0xFFFF) return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t smem = (static_cast<size_t>(W) * P + static_cast<size_t>(IB) * W + 4 * R) * 4;
  if (smem + 4096 > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(plu_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plu_block, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  unsigned long long* cand = scratch;
  unsigned long long* cand_row = scratch + 2 * max_ctas;
  unsigned ep = static_cast<unsigned>(epoch);
  void* args[] = {&p, &act, &piv, &info, &cand, &cand_row, &nb, &L, &blk,
                  &R, const_cast<int*>(&P), const_cast<int*>(&h), &ep};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(plu_block), dim3(G), dim3(NTH), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
