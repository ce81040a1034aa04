// Batched inverse iteration on a symmetric tridiagonal (K12), in FP32 and
// FP64:
//   slate_stein_f32, slate_stein_f64
//
// Replaces no Pallas kernel: the JAX package runs this solve as two
// lax.scan loops that XLA keeps on the device (_solve_batch and
// _stein_iter_core, slate_tpu/linalg/stein.py:49-141). Each of k systems
// (T - lam_j I) x_j = b_j is solved by Gaussian elimination with 2-row
// partial pivoting (LAPACK dlagtf), fill-in within two superdiagonals, then
// back-substituted; `iters` sweeps with a max-renormalisation of every
// column between them, then each column is scaled to unit 2-norm and its
// largest entry made positive. An eager PyTorch version of the row loop
// runs ~25 elementwise launches a row, ~8e5 at n = 8192: host time for
// work the card does in milliseconds.
//
// Bound on an H100: the bytes (each column's n rows are read and written
// once a pass, ~2 flops a byte at most) and, below them, latency: every row
// of a system depends on the row before it, so a thread's walk over n rows
// is a chain of n dependent steps a pass.
// Design: one thread a system (column j), n steps in order, the pivot
// candidate row in registers. The fill arrays U (pivots), V (+1), W (+2)
// and the eliminated right-hand side R are [n, k] row-major, as are the
// right-hand side and then x in X, so a warp's 32 columns are one 128-byte
// access (FP32) for each row of each array.
// Each step's inputs (the next row of T and of X) are loaded one step
// ahead, so the loads overlap the chain. Every arithmetic step is one
// IEEE operation rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn and
// their double forms: no contraction into FMA), in the order of the plain
// version's elementwise ops, so the result up to the final 2-norm is the
// plain version's bit for bit; the 2-norm sums in double, in row order.
//
// Overflow: a pivot replaced by 4 * FLT_MIN makes x as large as |r| *
// 2.1e37, past FP32's range once |r| > 16, and the JAX package's column
// then turns to NaN. Here a back-substitution that meets a non-finite x
// starts again from the last row with R scaled by 2^-64 (exact: a power of
// two), up to three times; the max-renormalisation that follows removes
// the scale, so the column is the one an unbounded exponent would give.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static float max(float a, float b) { return fmaxf(a, b); }
};

template <>
struct Ops<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double abs(double a) { return ::fabs(a); }
  __device__ static double max(double a, double b) { return ::fmax(a, b); }
};

// Solve (T - lam I) x = b for column j: forward elimination (pivot rows
// into U, V, W and R) then back-substitution (x into X, over b). Returns
// max |x_i| over the column.
template <typename T>
__device__ T solve_column(const T* __restrict__ d, const T* __restrict__ e, T lam,
                          T* __restrict__ X, T* __restrict__ U, T* __restrict__ V,
                          T* __restrict__ W, T* __restrict__ R, int n, int k, int j) {
  using O = Ops<T>;
  const size_t ld = static_cast<size_t>(k);
  const T zero = T(0), one = T(1);
  if (n == 1) {
    const T a0 = O::sub(d[0], lam);
    const T x = O::div(X[j], a0 == zero ? one : a0);
    X[j] = x;
    return O::abs(x);
  }
  // the current pivot-candidate row (a, b, c | r)
  T a = O::sub(d[0], lam), b = e[0], c = zero, r = X[j];
  // row i's inputs, one step ahead
  T dmi = d[1], dui = n > 2 ? e[1] : zero, dli = e[0], bi = X[ld + j];
  for (int i = 1; i < n; ++i) {
    const T dm_next = i + 1 < n ? d[i + 1] : zero;
    const T du_next = i + 2 < n ? e[i + 1] : zero;
    const T dl_next = i + 1 < n ? e[i] : zero;
    const T b_next = i + 1 < n ? X[static_cast<size_t>(i + 1) * ld + j] : zero;
    const T an = O::sub(dmi, lam);
    const bool swap = O::abs(dli) > O::abs(a);
    const T pa = swap ? dli : a, pb = swap ? an : b, pc = swap ? dui : c, pr = swap ? bi : r;
    const T qa = swap ? a : dli, qb = swap ? b : an, qc = swap ? c : dui, qr = swap ? r : bi;
    const T m = pa == zero ? zero : O::div(qa, pa);
    const size_t o = static_cast<size_t>(i - 1) * ld + j;
    U[o] = pa;
    V[o] = pb;
    W[o] = pc;
    R[o] = pr;
    a = O::sub(qb, O::mul(m, pb));
    b = O::sub(qc, O::mul(m, pc));
    c = zero;
    r = O::sub(qr, O::mul(m, pr));
    dmi = dm_next;
    dui = du_next;
    dli = dl_next;
    bi = b_next;
  }
  const size_t last = static_cast<size_t>(n - 1) * ld + j;
  U[last] = a;
  V[last] = zero;
  W[last] = zero;
  R[last] = r;
  // back-substitution, x_i = (r_i - v_i x_{i+1} - w_i x_{i+2}) / u_i, with
  // |u_i| below 4 * FLT_MIN replaced by that value, its sign kept (the JAX
  // package's threshold, in both precisions); on a non-finite x, again
  // with R scaled by 2^-64
  const T tiny = static_cast<T>(FLT_MIN * 4.0f);
  const T down = static_cast<T>(5.421010862427522e-20);  // 2^-64
  T scale = one, smax = zero;
  for (int attempt = 0; attempt < 4; ++attempt) {
    T x1 = zero, x2 = zero;
    smax = zero;
    bool finite = true;
    size_t o = last;
    T u = U[o], v = V[o], w = W[o], rr = R[o];
    for (int i = n - 1; i >= 0; --i) {
      T un = zero, vn = zero, wn = zero, rn = zero;
      if (i > 0) {
        const size_t on = o - ld;
        un = U[on];
        vn = V[on];
        wn = W[on];
        rn = R[on];
      }
      const T us = O::abs(u) < tiny ? (u < zero ? -tiny : tiny) : u;
      const T rs = attempt ? O::mul(rr, scale) : rr;
      const T x = O::div(O::sub(O::sub(rs, O::mul(v, x1)), O::mul(w, x2)), us);
      X[o] = x;
      if (!isfinite(x)) {
        finite = false;
        if (attempt < 3) break;
      }
      smax = O::max(smax, O::abs(x));
      x2 = x1;
      x1 = x;
      u = un;
      v = vn;
      w = wn;
      rr = rn;
      o -= ld;
    }
    if (finite) break;
    scale = O::mul(scale, down);
  }
  return smax;
}

template <typename T>
__global__ void __launch_bounds__(64)
    stein_kernel(const T* __restrict__ d, const T* __restrict__ e,
                 const T* __restrict__ lam, T* __restrict__ X, T* __restrict__ U,
                 T* __restrict__ V, T* __restrict__ W, T* __restrict__ R, int n, int k,
                 int iters) {
  using O = Ops<T>;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const size_t ld = static_cast<size_t>(k);
  const T zero = T(0), one = T(1);
  const T lj = lam[j];
  for (int it = 0; it < iters; ++it) {
    const T s = solve_column(d, e, lj, X, U, V, W, R, n, k, j);
    const T sd = s == zero ? one : s;
    for (int i = 0; i < n; ++i) {
      const size_t o = static_cast<size_t>(i) * ld + j;
      X[o] = O::div(X[o], sd);
    }
  }
  // unit 2-norm, then the largest |entry| (the first on ties) positive
  double ss = 0;
  for (int i = 0; i < n; ++i) {
    const T x = X[static_cast<size_t>(i) * ld + j];
    ss += static_cast<double>(x) * x;
  }
  const T nrm = static_cast<T>(sqrt(ss));
  const T nd = nrm == zero ? one : nrm;
  T best = -one, sgn = one;
  for (int i = 0; i < n; ++i) {
    const T y = O::div(X[static_cast<size_t>(i) * ld + j], nd);
    if (O::abs(y) > best) {
      best = O::abs(y);
      sgn = y > zero ? one : (y < zero ? -one : one);
    }
  }
  for (int i = 0; i < n; ++i) {
    const size_t o = static_cast<size_t>(i) * ld + j;
    X[o] = O::mul(O::div(X[o], nd), sgn);
  }
}

template <typename T>
int launch(const T* d, const T* e, const T* lam, T* X, T* U, T* V, T* W, T* R, int n,
           int k, int iters, void* stream) {
  if (n < 1 || k < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = 64;
  stein_kernel<T><<<(k + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(d, e, lam, X, U, V, W, R, n, k, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int slate_stein_f32(const float* d, const float* e, const float* lam, float* X,
                               float* U, float* V, float* W, float* R, int n, int k,
                               int iters, void* stream) {
  return launch<float>(d, e, lam, X, U, V, W, R, n, k, iters, stream);
}

extern "C" int slate_stein_f64(const double* d, const double* e, const double* lam, double* X,
                               double* U, double* V, double* W, double* R, int n, int k,
                               int iters, void* stream) {
  return launch<double>(d, e, lam, X, U, V, W, R, n, k, iters, stream);
}
