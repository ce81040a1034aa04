// Householder QR of one 128-column subpanel, in place, in FP32:
//   slate_qr_subpanel_f32
//
// Replaces _qr_kernel behind _qr_call (slate_tpu/internal/panel_qr.py), which
// holds the subpanel transposed, [128, h], in VMEM. Here the subpanel is the
// row-major window a[h][128] of the panel (row stride ld), read and written
// in place; rows above d0 hold finished R rows and are never read or written.
// For j in 0..127, with the diagonal at row dj = d0 + j:
//   alpha = a[dj][j], xnorm2 = sum_{i > dj} a[i][j]^2;
//   xnorm2 == 0: tau = 0, beta = alpha; otherwise sgn = sign(alpha) with
//   sign(0) = +1, beta = -sgn * sqrt(alpha^2 + xnorm2), tau = (beta - alpha)/beta;
//   v[dj] = 1, v[i] = a[i][j] / (alpha - beta) for i > dj;
//   column j becomes beta at dj and v below; every column k > j takes
//   a_k -= tau * v * (v^T a_k).
// The JAX kernel's IB=8 strips with a compact-WY strip-end update only feed
// the MXU; applying each reflector eagerly is the same in exact arithmetic.
//
// Bound on an H100: latency, as for the panel LU (panel_plu.cu): 128
// dependent columns, each a reduction over all rows; the bytes
// (2 h 128 4 B) and flops (~4 h 128^2) are a few us of work at h = 16384.
// Design: one cooperative launch, one CTA per SM, each holding its band of
// the rows below d0 in shared memory (<= 125 x 128 f32 = 64 KB at h = 16384)
// for the whole call. Per column, every CTA publishes its partial sums
// s_k = sum_{own i > dj} a[i][j] a[i][k] for k = j..127 (s_j is its share of
// xnorm2) and the owner of row dj publishes that row; one grid barrier;
// then every CTA reduces the partials in the same fixed order, so all derive
// bit-identical alpha, beta, tau and v^T a_k = a[dj][k] + s_k / (alpha - beta),
// and updates its own rows. The scratch is double-buffered by column parity,
// so one barrier per column suffices (as in panel_plu.cu), and is read and
// written with the L1-bypassing __ldcg / __stcg. A grid that cannot be
// co-resident makes the launch fail; it never hangs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int W = 128;        // subpanel width
constexpr int NTH = 256;      // threads per CTA: two halves of W threads
constexpr int MIN_ROWS = 32;  // fewest rows a CTA holds

__global__ void __launch_bounds__(NTH)
qr_subpanel(float* __restrict__ a, long long ld, int hh, float* __restrict__ tau,
            float* part, float* head, int R, int RP) {
  extern __shared__ float sm[];
  float* sx = sm;              // [W][RP]: sx[c * RP + i] = a[r0 + i][c]
  __shared__ float red[2][W];  // the two halves' sums
  __shared__ float s[W];       // the column's reduced sums
  __shared__ float hrow[W];    // the diagonal row
  __shared__ float tw[W];      // tau * v^T a_k
  __shared__ float sc[3];      // beta, tau, alpha - beta

  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  const int tid = threadIdx.x, k = tid % W, half = tid / W;
  const int r0 = g * R;
  const int nr = max(0, min(R, hh - r0));

  for (int idx = tid; idx < nr * W; idx += NTH) {
    const int i = idx / W, c = idx % W;
    sx[c * RP + i] = a[(r0 + i) * ld + c];
  }
  __syncthreads();

  // each half of the threads sums over its half of this CTA's rows
  const int hr = (nr + 1) / 2;
  const int i_lo = half * hr, i_hi = min(nr, i_lo + hr);

  for (int j = 0; j < W; ++j) {
    const int slot = j & 1;
    float* pslot = part + static_cast<size_t>(slot) * G * W;
    float* hslot = head + slot * W;
    // partial sums over own rows below the diagonal
    if (k >= j) {
      float acc0 = 0.f, acc1 = 0.f;
      int i = max(i_lo, j + 1 - r0);
      for (; i + 1 < i_hi; i += 2) {
        acc0 = fmaf(sx[j * RP + i], sx[k * RP + i], acc0);
        acc1 = fmaf(sx[j * RP + i + 1], sx[k * RP + i + 1], acc1);
      }
      if (i < i_hi) acc0 = fmaf(sx[j * RP + i], sx[k * RP + i], acc0);
      red[half][k] = acc0 + acc1;
    }
    __syncthreads();
    if (half == 0 && k >= j) {
      __stcg(pslot + static_cast<size_t>(g) * W + k, red[0][k] + red[1][k]);
      if (j >= r0 && j < r0 + nr) __stcg(hslot + k, sx[k * RP + (j - r0)]);
    }

    grid.sync();

    // every CTA reduces the partials in the same order
    if (k >= j) {
      const int glo = half * ((G + 1) / 2), ghi = min(G, glo + (G + 1) / 2);
      float acc = 0.f;
      for (int q = glo; q < ghi; ++q)
        acc += __ldcg(pslot + static_cast<size_t>(q) * W + k);
      red[half][k] = acc;
      if (half == 0) hrow[k] = j < hh ? __ldcg(hslot + k) : 0.f;
    }
    __syncthreads();
    if (half == 0 && k >= j) s[k] = red[0][k] + red[1][k];
    __syncthreads();
    if (tid == 0) {
      const float alpha = hrow[j], xnorm2 = s[j];
      float beta = alpha, t = 0.f, vden = 1.f;
      if (xnorm2 != 0.f) {
        const float sgn = alpha < 0.f ? -1.f : 1.f;
        beta = -sgn * sqrtf(alpha * alpha + xnorm2);
        t = (beta - alpha) / beta;
        vden = alpha - beta;
      }
      sc[0] = beta;
      sc[1] = t;
      sc[2] = vden;
      if (g == 0) tau[j] = t;
    }
    __syncthreads();
    const float beta = sc[0], t = sc[1], vden = sc[2];
    if (half == 0 && k > j) tw[k] = t * (hrow[k] + s[k] / vden);
    // column j: beta on the diagonal, v below
    for (int i = tid; i < nr; i += NTH) {
      const int r = r0 + i;
      if (r == j) sx[j * RP + i] = beta;
      else if (r > j) sx[j * RP + i] = sx[j * RP + i] / vden;
    }
    __syncthreads();
    // columns right of j: a_k -= v * (tau v^T a_k), rows at and below dj
    const int ilo = max(0, j - r0);
    const int rows = nr - ilo, nk = W - 1 - j;
    for (int idx = tid; idx < rows * nk; idx += NTH) {
      const int i = ilo + idx % rows, c = j + 1 + idx / rows;
      const float v = (r0 + i == j) ? 1.f : sx[j * RP + i];
      sx[c * RP + i] -= v * tw[c];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nr * W; idx += NTH) {
    const int i = idx / W, c = idx % W;
    a[(r0 + i) * ld + c] = sx[c * RP + i];
  }
}

}  // namespace

// a: the [h, 128] window, row stride ld (floats), unit column stride;
// factored in place from diagonal row d0. tau: [128]. Scratch from the
// caller: part holds 2 * max_ctas * 128 floats, head 2 * 128. Returns a
// CUDA error code (0 on success); a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge without launching.
extern "C" int slate_qr_subpanel_f32(float* a, long long ld, int h, int d0, float* tau,
                                     float* part, float* head, int max_ctas,
                                     void* stream) {
  const int hh = h - d0;  // rows from the diagonal down
  if (hh <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* base = a + static_cast<long long>(d0) * ld;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int R = (hh + sms - 1) / sms;
  if (R < MIN_ROWS) R = MIN_ROWS;
  const int G = (hh + R - 1) / R;
  if (G > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
  int RP = R | 1;  // odd column stride: a warp walking columns hits 32 banks
  const size_t smem = static_cast<size_t>(W) * RP * sizeof(float);
  e = cudaFuncSetAttribute(qr_subpanel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_subpanel, NTH, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < G) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int hh_arg = hh;
  void* args[] = {&base, &ld, &hh_arg, &tau, &part, &head, &R, &RP};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(qr_subpanel), dim3(G), dim3(NTH),
                                  args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
