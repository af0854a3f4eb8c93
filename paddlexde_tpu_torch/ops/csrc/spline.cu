// Cubic Hermite gather-evaluation of a history series at L fractional
// queries, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/spline_pallas.py
// (_eval_pallas, reached through _gather_eval_impl by hermite_gather_eval
// and by its backward with the derivative basis).
//
//   out[b, l, c] = c_p0 x[b,i,c] + c_m0 m[b,i,c] + c_p1 x[b,i+1,c] + c_m1 m[b,i+1,c]
//
// with i = clip(searchsorted(t, q_l, right) - 1, 0, T-2), frac = (q_l - t_i)
// / h (h = t_{i+1} - t_i, or 1 where that is 0), the Hermite basis of frac
// (or its derivative in q, for the lag backward), and forward-difference
// slopes m[b,j,c] = (x[b,j+1,c] - x[b,j,c]) / (t[j+1] - t[j]), the last one
// repeated. The TPU kernel reads a precomputed slope array in a [T, C] lane
// layout and gets the index and basis from the wrapper; here each thread
// derives them from t and its query (a binary search over t, as
// torch.searchsorted does, and a few scalar operations) and forms both
// slopes from rows i, i+1 and i2 = min(i+2, T-1) of the series in its
// native [rows, T, D] layout: m1 is taken between rows i2-1 and i2, which is
// m[i+1] when i+2 < T and the repeated last slope otherwise. So one launch
// does the whole lookup, with no preparatory kernels.
//
// Every product, quotient and sum is rounded on its own (never contracted
// into an FMA), in the plain version's order: queries out of range
// extrapolate the end cubic with coefficients of order frac^3, where a
// contracted FMA changes the cancellation by far more than a rounding step.
// The kernel then matches the plain version bit for bit.
//
// Bound: bytes. Each output element needs 3 rows of D values; the kernel
// touches only the rows the queries name (not the whole series), one thread
// per output element, and writes the output once, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

// first index j with t[j] > q (torch.searchsorted(..., right=True))
template <typename scalar_t>
__device__ __forceinline__ int upper_bound(const scalar_t* __restrict__ t, int n, scalar_t q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(t[mid] > q)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename scalar_t>
__global__ void hermite_gather_kernel(
    const scalar_t* __restrict__ x, const scalar_t* __restrict__ t,
    const scalar_t* __restrict__ q, scalar_t* __restrict__ out, int64_t rows,
    int t_len, int d, int n_q, int derivative) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= rows * n_q * d) return;
  const int c = (int)(gid % d);
  const int64_t r = gid / d;
  const int l = (int)(r % n_q);
  const int64_t b = r / n_q;

  const scalar_t ql = q[l];
  const int i = min(max(upper_bound(t, t_len, ql) - 1, 0), t_len - 2);
  const int i2 = min(i + 2, t_len - 1);
  const scalar_t t0 = t[i], t1 = t[i + 1];
  const scalar_t h = t1 == t0 ? scalar_t(1) : sub(t1, t0);
  const scalar_t fx = div(sub(ql, t0), h);
  const scalar_t x2 = mul(fx, fx);
  scalar_t c_p0, c_m0, c_p1, c_m1;
  if (derivative) {
    c_p0 = div(sub(mul(scalar_t(6), x2), mul(scalar_t(6), fx)), h);
    c_m0 = add(sub(mul(scalar_t(3), x2), mul(scalar_t(4), fx)), scalar_t(1));
    c_p1 = div(add(mul(scalar_t(-6), x2), mul(scalar_t(6), fx)), h);
    c_m1 = sub(mul(scalar_t(3), x2), mul(scalar_t(2), fx));
  } else {
    const scalar_t x3 = mul(x2, fx);
    c_p0 = add(sub(mul(scalar_t(2), x3), mul(scalar_t(3), x2)), scalar_t(1));
    c_m0 = mul(add(sub(x3, mul(scalar_t(2), x2)), fx), h);
    c_p1 = add(mul(scalar_t(-2), x3), mul(scalar_t(3), x2));
    c_m1 = mul(sub(x3, x2), h);
  }

  const scalar_t* xb = x + b * t_len * d + c;
  const scalar_t p0 = xb[(int64_t)i * d];
  const scalar_t p1 = xb[(int64_t)(i + 1) * d];
  const scalar_t pa = xb[(int64_t)(i2 - 1) * d];
  const scalar_t pb = xb[(int64_t)i2 * d];
  const scalar_t m0 = div(sub(p1, p0), sub(t1, t0));
  const scalar_t m1 = div(sub(pb, pa), sub(t[i2], t[i2 - 1]));
  scalar_t acc = mul(c_p0, p0);
  acc = add(acc, mul(c_m0, m0));
  acc = add(acc, mul(c_p1, p1));
  out[gid] = add(acc, mul(c_m1, m1));
}

template <typename scalar_t>
static int launch(const void* x, const void* t, const void* q, void* out, int64_t rows,
                  int t_len, int d, int n_q, int derivative, void* stream) {
  const int64_t total = rows * n_q * d;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  hermite_gather_kernel<scalar_t><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const scalar_t*)x, (const scalar_t*)t, (const scalar_t*)q, (scalar_t*)out, rows,
      t_len, d, n_q, derivative);
  return (int)cudaGetLastError();
}

extern "C" int pxt_hermite_gather_f32(const void* x, const void* t, const void* q, void* out,
                                      int64_t rows, int t_len, int d, int n_q, int derivative,
                                      void* stream) {
  return launch<float>(x, t, q, out, rows, t_len, d, n_q, derivative, stream);
}

extern "C" int pxt_hermite_gather_f64(const void* x, const void* t, const void* q, void* out,
                                      int64_t rows, int t_len, int d, int n_q, int derivative,
                                      void* stream) {
  return launch<double>(x, t, q, out, rows, t_len, d, n_q, derivative, stream);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
