// Householder QR of one 128-column subpanel, in place, in FP32:
//   slate_qr_subpanel_f32
//
// Replaces _qr_kernel behind _qr_call (slate_tpu/internal/panel_qr.py), which
// holds the subpanel transposed, [128, h], in VMEM. Here the subpanel is the
// row-major window a[h][128] of the panel (row stride ld), read and written
// in place; rows above d0 hold finished R rows and are never read or written.
// For j in 0..min(127, hh - 1), hh = h - d0, with the diagonal at row dj = d0 + j:
//   alpha = a[dj][j], xnorm2 = sum_{i > dj} a[i][j]^2;
//   xnorm2 == 0: tau = 0, beta = alpha; otherwise sgn = sign(alpha) with
//   sign(0) = +1, beta = -sgn * sqrt(alpha^2 + xnorm2), tau = (beta - alpha)/beta;
//   rv = 1 / (alpha - beta) (1 when xnorm2 == 0); v[dj] = 1, v[i] = a[i][j] rv
//   for i > dj (LAPACK's larfg scales by the reciprocal too);
//   column j becomes beta at dj and v below; every column k > j takes
//   a_k -= v * tw_k, tw_k = tau (a[dj][k] + s_k rv),
//   s_k = sum_{i > dj} a[i][j] a[i][k] (so tw_k = tau v^T a_k).
// The JAX kernel's IB=8 strips with a compact-WY strip-end update only feed
// the MXU; applying each reflector eagerly is the same in exact arithmetic.
//
// Bound on an H100: latency, as for the panel LU (panel_plu.cu): 128
// dependent columns, each a reduction over all rows; the bytes
// (2 h 128 4 B) and flops (~4 h 128^2) are a few us of work at h = 16384.
// Design: one cooperative launch of G CTAs (one per SM), each holding its
// band of R rows below d0 in shared memory, column-major with an odd pitch,
// for the whole call. The design it replaced spent 13.0 us a column at
// h = 16384 (PERF.md section 6): a grid barrier (1.1 us), every CTA
// reducing all G partials of every k in one dependent chain of L2 loads a
// thread (4.0), the update with a run-time division per entry (2.5). Here,
// per column j (3.7 us at h = 16384):
//   * A two-level exchange of tagged words, no grid barrier and no memory
//     fence. Each CTA publishes its partial sums s_k of column j (k >= j) as
//     64-bit words, the value's bits beside a tag naming the launch (epoch)
//     and the column; the owner of row dj publishes that row the same way.
//     The owner of column k (CTA k mod G) waits for the G words of k, one
//     thread a word, sums them in q order (a lane a stride of q, then a
//     fixed butterfly) and publishes s_k; every CTA then waits for the s_k
//     and the row it needs, one thread a word. A word whose tag is not yet
//     there is read again. So every CTA gets the same bits of s_k, runs
//     repeat bit for bit, and a CTA reads 2 x 128 words a column where the
//     flat exchange had it read G x 128.
//   * Words live in global scratch kept from call to call (no memset),
//     double-buffered by column parity: nothing of column j + 2 is written
//     before every CTA has read column j's words, because each write of
//     column j + 2 follows its writer's reading of column j + 1's sums, which
//     follow every CTA's column j + 1 words, which each CTA publishes after
//     its column j exchange. tests/test_torch_panel_qr_sched.py models this.
//   * Every thread forms alpha, beta, tau and tw_k itself (no one-thread
//     larfg and barrier); one warp a row, 4 columns a lane, RB rows at once,
//     no division in any per-entry loop: one pass over the CTA's rows
//     writes v, updates the columns right of j (a fused multiply-add) and
//     sums the next column's partials (a'_{i,j+1} broadcast by a warp
//     shuffle); the warps' partials are added in warp order.
// A grid that cannot be co-resident makes the launch fail; it never hangs,
// and a wait over 2 s traps (a launch error) instead of hanging the card.

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;        // subpanel width
constexpr int NTH = 512;      // threads per CTA
constexpr int NW = NTH / 32;  // warps per CTA
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds
constexpr int GMAX = 384;     // largest grid: an owner's G words of its columns fit NTH threads
constexpr int RB = 4;         // rows a warp updates at once
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ULL;

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

// The tag of column j in the launch of this epoch (epoch < 2^24).
__device__ __forceinline__ unsigned col_tag(unsigned epoch, int j) {
  return (epoch << 8) | static_cast<unsigned>(j + 1);
}

__device__ __forceinline__ unsigned long long tagged(float v, unsigned tag) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) | tag;
}

// The value of the word at p once it carries `tag` (read again until it
// does; a wait over WAIT_LIMIT_NS traps).
__device__ __forceinline__ float wait_word(const unsigned long long* p, unsigned tag) {
  unsigned long long w = ld_relaxed(p), t0 = 0;
  while (static_cast<unsigned>(w) != tag) {
    const unsigned long long t = now_ns();
    if (t0 == 0) t0 = t;
    if (t - t0 > WAIT_LIMIT_NS) __trap();
    w = ld_relaxed(p);
  }
  return __uint_as_float(static_cast<unsigned>(w >> 32));
}

__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
  return p;
}

// Shared state of a CTA besides its rows.
struct Shared {
  float part[NW][W];  // the warps' partial sums of the next column
  float red[NTH];     // an owner's G words of each of its columns
  float s[W];         // s_k of the column
  float hrow[W];      // its diagonal row
};

// The words of the scratch: the CTAs' partial sums, the owners' sums and
// the diagonal rows, each double-buffered by column parity.
struct Words {
  unsigned long long* part;  // [2][G][W]
  unsigned long long* sum;   // [2][W]
  unsigned long long* row;   // [2][W]
};

// Column c's exchange, once the warps' partials are in sh.part (this ends
// their barrier): this CTA's sums (in warp order) published as tagged
// words; each owner (g = k mod G) waits for the G words of its columns,
// one thread a word, sums them in q order (a lane a stride of q, then a
// fixed butterfly) and publishes s_k; every CTA waits for the s_k and the
// diagonal row it needs. kl, q: this thread's (owned column, word) slot.
__device__ void exchange(Shared& sh, const Words& ws, int g, int G, int c, unsigned tag,
                         int kl, int q) {
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, par = c & 1;
  __syncthreads();
  if (tid < W && tid >= c) {
    float s = sh.part[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += sh.part[w][tid];
    st_relaxed(ws.part + (static_cast<size_t>(par) * G + g) * W + tid, tagged(s, tag));
  }
  const int own = (W - 1 - g) / G + 1;  // columns g, g + G, ... below W
  if (g < W && kl < own && g + kl * G >= c)
    sh.red[kl * G + q] =
        wait_word(ws.part + (static_cast<size_t>(par) * G + q) * W + g + kl * G, tag);
  __syncthreads();
  if (g < W)
    for (int m = wp; m < own; m += NW) {
      const int k = g + m * G;
      if (k < c) continue;
      float s = 0.f;
      for (int p = lane; p < G; p += 32) s += sh.red[m * G + p];
      s = warp_sum(s);
      if (lane == 0) st_relaxed(ws.sum + par * W + k, tagged(s, tag));
    }
  if (tid < W && tid >= c) sh.s[tid] = wait_word(ws.sum + par * W + tid, tag);
  if (tid >= W && tid < 2 * W && tid - W >= c)
    sh.hrow[tid - W] = wait_word(ws.row + par * W + tid - W, tag);
  __syncthreads();
}

__device__ __forceinline__ float pick(const float (&x)[4], int jj) {
  return jj == 0 ? x[0] : jj == 1 ? x[1] : jj == 2 ? x[2] : x[3];
}

__global__ void __launch_bounds__(NTH)
qr_subpanel(float* __restrict__ a, long long ld, int hh, float* __restrict__ tau,
            unsigned long long* scratch, int R, int RP, unsigned epoch) {
  extern __shared__ float sx[];  // [W][RP]: sx[c * RP + i] = a[r0 + i][c]
  __shared__ Shared sh;
  const int g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int r0 = g * R;
  const int nr = max(0, min(R, hh - r0));
  const int jn = min(W, hh);
  const Words ws{scratch, scratch + 2 * static_cast<size_t>(G) * W,
                 scratch + 2 * static_cast<size_t>(G) * W + 2 * W};
  const int kl = tid / G, q = tid - kl * G;  // this thread's owner slot

  for (int i = wp; i < nr; i += NW)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = lane + 32 * jj;
      sx[c * RP + i] = a[static_cast<long long>(r0 + i) * ld + c];
    }
  __syncthreads();

  // column 0's partials and diagonal row
  {
    float acc[4] = {};
    for (int i = wp; i < nr; i += NW) {
      float x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) x[jj] = sx[(lane + 32 * jj) * RP + i];
      const float x0 = __shfl_sync(0xffffffffu, x[0], 0);
      if (r0 + i > 0)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[jj] = fmaf(x0, x[jj], acc[jj]);
      if (r0 + i == 0)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          st_relaxed(ws.row + lane + 32 * jj, tagged(x[jj], col_tag(epoch, 0)));
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) sh.part[wp][lane + 32 * jj] = acc[jj];
  }
  exchange(sh, ws, g, G, 0, col_tag(epoch, 0), kl, q);

  for (int j = 0; j < jn; ++j) {
    // every thread alike: alpha, beta, tau, 1 / (alpha - beta), and tw of
    // its columns
    const float alpha = sh.hrow[j], xnorm2 = sh.s[j];
    float beta = alpha, t = 0.f, vden = 1.f;
    if (xnorm2 != 0.f) {
      const float sgn = alpha < 0.f ? -1.f : 1.f;
      beta = -sgn * sqrtf(alpha * alpha + xnorm2);
      t = (beta - alpha) / beta;
      vden = alpha - beta;
    }
    const float rv = 1.f / vden;
    if (g == 0 && tid == 0) tau[j] = t;
    float tw[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int k = lane + 32 * jj;
      tw[jj] = k > j ? __fmul_rn(t, __fadd_rn(sh.hrow[k], __fmul_rn(sh.s[k], rv))) : 0.f;
    }
    const int jx = j + 1, jl = jx & 31, jj1 = (jx >> 5) & 3;
    const bool next = jx < jn;
    unsigned long long* rnext = ws.row + (jx & 1) * W;
    const unsigned tagn = col_tag(epoch, jx);
    // one pass over this CTA's rows at and below the diagonal, RB at once:
    // v into column j, the update of the columns right of it, and column
    // jx's partial sums and diagonal row
    float acc[4] = {};
    const int ilo = max(0, j - r0);
    for (int i0 = ilo + wp; i0 < nr; i0 += NW * RB) {
      float x[RB][4], aj[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + NW * r;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) x[r][jj] = i < nr ? sx[(lane + 32 * jj) * RP + i] : 0.f;
        aj[r] = i < nr ? sx[j * RP + i] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + NW * r;
        if (i >= nr) break;
        const bool diag = r0 + i == j;
        const float v = diag ? 1.f : __fmul_rn(aj[r], rv);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int k = lane + 32 * jj;
          const float y = k == j ? (diag ? beta : v) : fmaf(-v, tw[jj], x[r][jj]);
          if (k >= j) sx[k * RP + i] = x[r][jj] = y;
        }
        const float xn = __shfl_sync(0xffffffffu, pick(x[r], jj1), jl);
        const float m = r0 + i > jx ? xn : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[jj] = fmaf(m, x[r][jj], acc[jj]);
      }
    }
    if (!next) break;
    // the warp that updated row jx publishes it (no store to global inside
    // the pass, whose loads and stores the compiler may then reorder)
    const int ih = jx - r0;
    if (ih >= 0 && ih < nr && wp == (ih - ilo) % NW) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = lane + 32 * jj;
        if (k >= jx) st_relaxed(rnext + k, tagged(sx[k * RP + ih], tagn));
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) sh.part[wp][lane + 32 * jj] = acc[jj];
    exchange(sh, ws, g, G, jx, tagn, kl, q);
  }
  if (g == 0)
    for (int j = jn + tid; j < W; j += NTH) tau[j] = 0.f;
  __syncthreads();
  for (int i = wp; i < nr; i += NW)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = lane + 32 * jj;
      a[static_cast<long long>(r0 + i) * ld + c] = sx[c * RP + i];
    }
}

}  // namespace

// a: the [h, 128] window, row stride ld (floats), unit column stride;
// factored in place from diagonal row d0. tau: [128]. scratch: the
// caller's (2 ctas + 4) * 128 words, kept from call to call; epoch: this
// launch's (1 .. 2^24 - 1), every earlier launch on the scratch had a
// smaller one or the scratch was zeroed since. ctas: the grid to spread the
// hh = h - d0 rows over (fewer if the rows run out first, at least
// MIN_ROWS a CTA). Returns a CUDA error code (0 on success); a grid that
// cannot be co-resident returns cudaErrorCooperativeLaunchTooLarge without
// launching.
extern "C" int slate_qr_subpanel_f32(float* a, long long ld, int h, int d0, float* tau,
                                     unsigned long long* scratch, int ctas, unsigned epoch,
                                     void* stream) {
  const int hh = h - d0;  // rows from the diagonal down
  if (hh <= 0 || ctas < 1 || ctas > GMAX || epoch == 0 || epoch >= (1u << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  float* base = a + static_cast<long long>(d0) * ld;
  int R = (hh + ctas - 1) / ctas;
  if (R < MIN_ROWS) R = MIN_ROWS;
  const int G = (hh + R - 1) / R;
  int RP = R | 1;  // odd column stride: a warp walking columns hits 32 banks
  const size_t smem = static_cast<size_t>(W) * RP * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(qr_subpanel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_subpanel, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int hh_arg = hh;
  void* args[] = {&base, &ld, &hh_arg, &tau, &scratch, &R, &RP, &epoch};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(qr_subpanel), dim3(G), dim3(NTH), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
