// Bulge chaser of the two-stage SVD, in FP32:
//   slate_tb2bd_f32  upper band -> upper bidiagonal (replaces _tb2bd_vmem_jit,
//                    slate_tpu/internal/band_wave_vmem_bd.py)
// (its eigensolver twin, K8 slate_hb2st_f32, is hb2st_chase.cu, whose
// design of one cooperative launch this kernel has still to take).
//
// It computes the task DAG of the numpy twin (slate_tpu/internal/band_bulge.py):
// task (sweep s, chase t) generates two Householder reflectors of length
// L <= b acting on indices [s + 1 + t b, s + t b + L] and applies them
// inside a few b x b blocks of the band; task (s, t) needs only the U-side
// reflector of task (s, t - 1). Run in wave w = 2 s + t, the tasks of one
// wave touch disjoint elements, so a wave's tasks run in parallel and the
// waves in order.
//
// The band lives in a ribbon in device memory: element (r, c) at
// rib[r (4b - 1) + c + 2b - 1], so each c - r in [-(2b - 1), 2b] has a slot
// of its own (17 MB at n = 8192, b = 128: resident in L2). The TPU kernels
// shear their blocks across lanes and move rows with one-hot MXU products;
// none of that is needed here: a task's block is a strided window of the
// ribbon.
//
// Bound on an H100: latency. There are ~2n dependent waves of small
// Householder steps; the flops (~16 b^2 a task) and the reflector packs, the
// one large write, are a few ms of work at n = 8192, b = 128. Design: the C
// entry point launches one grid per wave on the caller's stream, one CTA per
// task. The CTA stages its b x b blocks in shared memory (bands <= 128; up
// to 256 in the global scratch the caller passes), runs the task's steps
// with __syncthreads between them, and writes the blocks back. Every
// reduction over a block's rows or columns runs in a fixed order inside the
// CTA (four contiguous partial sums per output, added in order), so runs
// repeat bit for bit. larfg follows the twin: beta = -sign(alpha) ||x||
// with sign(0) = +1; tau = 0 and beta = alpha when ||x[1:]|| = 0; v[0] = 1.

#include <cuda_runtime.h>

namespace {

constexpr int NTH = 512;        // threads per CTA
constexpr int BMAX = 256;       // widest band
constexpr int SMEM_BMAX = 128;  // widest band whose two blocks fit shared memory
constexpr int NP = NTH / 128;   // partial sums per output of a reduction
static_assert(NP == 4, "matvec adds four partial sums");

// element (r, c) of the band at p[r * ld + c + off], ld = 4b - 1, off = 2b - 1
struct Ribbon {
  float* p;
  long long ld;
  int off;
  __device__ __forceinline__ float& at(int r, int c) const {
    return p[static_cast<long long>(r) * ld + c + off];
  }
};

struct Vectors {
  float x[BMAX];  // the reflector being generated
  float y[BMAX];  // the previous task's reflector, then a second one
  float w[BMAX];  // products of a block and a reflector
  float red[NP][128];
  float sc[4];    // beta, tau, alpha - beta
};

// out[o] = sum_{i < len} M[o so + i si] x[i] for o < nout.
__device__ void matvec(const float* M, int so, int si, const float* x, int nout,
                       int len, float* out, float (*red)[128]) {
  const int ol = threadIdx.x % 128, p = threadIdx.x / 128;
  const int chunk = (len + NP - 1) / NP;
  const int lo = p * chunk, hi = min(len, lo + chunk);
  for (int o0 = 0; o0 < nout; o0 += 128) {
    const int o = o0 + ol;
    if (o < nout) {
      float acc = 0.f;
      for (int i = lo; i < hi; ++i) acc = fmaf(M[o * so + i * si], x[i], acc);
      red[p][ol] = acc;
    }
    __syncthreads();
    if (p == 0 && o < nout) out[o] = (red[0][ol] + red[1][ol]) + (red[2][ol] + red[3][ol]);
    __syncthreads();
  }
}

// LAPACK larfg on x[0..L) in place: x becomes v; sc = {beta, tau, alpha - beta}.
__device__ void larfg(float* x, int L, float* sc) {
  if (threadIdx.x < 32) {
    float acc = 0.f;
    for (int i = 1 + threadIdx.x; i < L; i += 32) acc = fmaf(x[i], x[i], acc);
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (threadIdx.x == 0) {
      const float alpha = x[0];
      float beta = alpha, tau = 0.f, vden = 1.f;
      if (acc != 0.f) {
        const float sgn = alpha < 0.f ? -1.f : 1.f;
        beta = -sgn * sqrtf(alpha * alpha + acc);
        tau = (beta - alpha) / beta;
        vden = alpha - beta;
      }
      sc[0] = beta;
      sc[1] = tau;
      sc[2] = vden;
    }
  }
  __syncthreads();
  const float vden = sc[2];
  for (int i = 1 + threadIdx.x; i < L; i += NTH) x[i] = x[i] / vden;
  if (threadIdx.x == 0) x[0] = 1.f;
  __syncthreads();
}

// M[i][k] = A(r0 + i, c0 + k), i < nr, k < nc
__device__ void load(float* M, int ld, const Ribbon& R, int r0, int nr, int c0, int nc) {
  for (int idx = threadIdx.x; idx < nr * nc; idx += NTH) {
    const int i = idx / nc, k = idx % nc;
    M[i * ld + k] = R.at(r0 + i, c0 + k);
  }
}

__device__ void store(const float* M, int ld, const Ribbon& R, int r0, int nr, int c0, int nc) {
  for (int idx = threadIdx.x; idx < nr * nc; idx += NTH) {
    const int i = idx / nc, k = idx % nc;
    R.at(r0 + i, c0 + k) = M[i * ld + k];
  }
}

// The task (s, t) of CTA blockIdx.x in wave w, or false if there is none.
__device__ bool task_of(int w, int s_lo, int n, int b, int T, int& s, int& t, int& i0) {
  s = s_lo + blockIdx.x;
  t = w - 2 * s;
  i0 = s + 1 + t * b;
  return s <= n - 2 && t >= 0 && t < T && i0 <= n - 1;
}

__device__ float* blocks(float* dyn, float* scratch, int b, int ld) {
  return b <= SMEM_BMAX ? dyn : scratch + static_cast<size_t>(blockIdx.x) * 2 * b * ld;
}

__global__ void __launch_bounds__(NTH)
tb2bd_wave(Ribbon R, int n, int b, int T, int w, int s_lo, float* __restrict__ Vu,
           float* __restrict__ tauu, float* __restrict__ Vv, float* __restrict__ tauv,
           float* scratch) {
  extern __shared__ float dyn[];
  __shared__ Vectors sh;
  int s, t, c0;
  if (!task_of(w, s_lo, n, b, T, s, t, c0)) return;
  const int L = min(b, n - c0), ld = b | 1, tid = threadIdx.x;
  float* B = blocks(dyn, scratch, b, ld);
  float* D = B + b * ld;
  float* v = sh.x;  // V side (columns)
  float* u = sh.y;  // U side (rows); the previous task's first
  const size_t task = static_cast<size_t>(s) * T + t;

  if (t == 0) {
    // annihilate row s right of the superdiagonal
    for (int k = tid; k < L; k += NTH) v[k] = R.at(s, c0 + k);
    __syncthreads();
    larfg(v, L, sh.sc);
    const float beta = sh.sc[0];
    for (int k = tid; k < L; k += NTH) R.at(s, c0 + k) = k == 0 ? beta : 0.f;
  } else {
    // B = A[r0 : r0 + b, c0 : c0 + L], below it the diagonal block
    const int r0 = c0 - b;
    load(B, ld, R, r0, b, c0, L);
    for (int i = tid; i < b; i += NTH) u[i] = Vu[(task - 1) * b + i];
    const float tp = tauu[task - 1];
    __syncthreads();
    // the previous U-side reflector's deferred left-apply makes the fill
    matvec(B, 1, ld, u, L, b, sh.w, sh.red);  // w = u^T B
    for (int idx = tid; idx < b * L; idx += NTH) {
      const int i = idx / L, k = idx % L;
      B[i * ld + k] -= (tp * u[i]) * sh.w[k];
    }
    __syncthreads();
    for (int k = tid; k < L; k += NTH) v[k] = B[k];
    __syncthreads();
    larfg(v, L, sh.sc);
    const float beta = sh.sc[0], tv = sh.sc[1];
    // annihilate row 0's tail; right-apply to the rows below it
    matvec(B + ld, ld, 1, v, b - 1, L, sh.w, sh.red);
    for (int idx = tid; idx < b * L; idx += NTH) {
      const int i = idx / L, k = idx % L;
      if (i == 0) B[k] = k == 0 ? beta : 0.f;
      else B[i * ld + k] -= (tv * sh.w[i - 1]) * v[k];
    }
    __syncthreads();
    store(B, ld, R, r0, b, c0, L);
  }

  // the diagonal block: right-apply v, then the U-side reflector from its
  // column 0, left-applied
  const float tv = sh.sc[1];
  load(D, ld, R, c0, L, c0, L);
  __syncthreads();
  matvec(D, ld, 1, v, L, L, sh.w, sh.red);  // w = D v
  for (int idx = tid; idx < L * L; idx += NTH) {
    const int i = idx / L, k = idx % L;
    D[i * ld + k] -= (tv * sh.w[i]) * v[k];
  }
  __syncthreads();
  for (int i = tid; i < L; i += NTH) u[i] = D[i * ld];
  __syncthreads();
  larfg(u, L, sh.sc);
  const float beta = sh.sc[0], tu = sh.sc[1];
  matvec(D + 1, 1, ld, u, L - 1, L, sh.w, sh.red);  // w = u^T D[:, 1:]
  for (int idx = tid; idx < L * L; idx += NTH) {
    const int i = idx / L, k = idx % L;
    if (k == 0) D[i * ld] = i == 0 ? beta : 0.f;
    else D[i * ld + k] -= (tu * u[i]) * sh.w[k - 1];
  }
  __syncthreads();
  store(D, ld, R, c0, L, c0, L);
  for (int i = tid; i < L; i += NTH) {
    Vv[task * b + i] = v[i];
    Vu[task * b + i] = u[i];
  }
  if (tid == 0) {
    tauv[task] = tv;
    tauu[task] = tu;
  }
}

// One grid per wave, the waves in order on the stream; CTA x of wave w runs
// task (s_lo + x, w - 2 (s_lo + x)), s_lo the wave's first sweep with a task.
template <typename Launch>
int run_waves(int n, int b, int max_ctas, Launch launch) {
  const int S = n - 1, T = (n - 2) / b + 1;
  const int waves = 2 * (S - 1) + T;
  for (int w = 0; w < waves; ++w) {
    const int s_hi = min(S - 1, w / 2);
    int s_lo = max(0, (w - T + 2) / 2);
    // a chase task exists while s + 1 + t b <= n - 1, t = w - 2 s
    const long long num = static_cast<long long>(w) * b - (n - 2);
    if (num > 0) s_lo = max(s_lo, static_cast<int>((num + 2 * b - 2) / (2 * b - 1)));
    if (s_lo > s_hi) continue;
    const int cnt = s_hi - s_lo + 1;
    if (cnt > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
    launch(w, s_lo, cnt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int prepare(K kernel, int n, int b, size_t* smem) {
  if (n < 2 || b < 1 || b > BMAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = b | 1;
  *smem = b <= SMEM_BMAX ? static_cast<size_t>(2) * b * ld * sizeof(float) : 0;
  return static_cast<int>(cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(*smem)));
}

}  // namespace

// rib: the ribbon, n (4b) floats, updated in place. Vu, Vv: [n-1, T, b] and
// tauu, tauv: [n-1, T], T = (n-2)/b + 1, zeroed by the caller: the U-side
// and V-side packs. scratch: 2 b (b|1) floats per CTA for b > 128.
// max_ctas: the most CTAs a wave may take (T/2 + 2). Returns a CUDA error
// code (0 on success).
extern "C" int slate_tb2bd_f32(float* rib, int n, int b, float* Vu, float* tauu, float* Vv,
                               float* tauv, float* scratch, int max_ctas, void* stream) {
  size_t smem = 0;
  int e = prepare(tb2bd_wave, n, b, &smem);
  if (e != 0) return e;
  const Ribbon R{rib, 4LL * b - 1, 2 * b - 1};
  const int T = (n - 2) / b + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_waves(n, b, max_ctas, [&](int w, int s_lo, int cnt) {
    tb2bd_wave<<<cnt, NTH, smem, st>>>(R, n, b, T, w, s_lo, Vu, tauu, Vv, tauv, scratch);
  });
}
