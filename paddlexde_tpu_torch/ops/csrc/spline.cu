// Cubic Hermite gather-evaluation of a history series at fractional
// queries, for Hopper (sm_90a): the history lookup K1 and its lag gradient.
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
// repeated: m1 is taken between rows i2-1 and i2 (i2 = min(i+2, T-1)), which
// is m[i+1] when i+2 < T and the repeated last slope otherwise. The TPU
// kernel reads a precomputed slope array in a [T, C] lane layout and gets
// the index and basis from the wrapper; here one launch does the whole
// lookup from the series in its native [rows, T, D] layout.
//
// What bounds it: launches and latency, not bytes. At D3STN's shapes (rows
// = B N = 5440, T = 2016, D = 3, 12 + 12 queries) a call moves ~2.6 MB, under
// a microsecond at the card's memory rate, and a launch costs about as much.
// So the design cuts launches and the dependent latency inside one:
//
// - one launch serves two query sets (the decoder and the encoder lags of
//   a batch), writing both outputs; one set is the same kernel with the
//   second set empty;
// - the per-query work is done once per CTA into shared memory (locate): a
//   warp takes a query's 64 knots around the index that linear
//   interpolation between the end knots guesses, and __ballot_sync over the
//   lanes' comparisons finds the segment there; the same loads hold the
//   knots of the basis. Evenly spaced knots (D3STN's history span) need no
//   more: two dependent loads a query, where a binary search takes 11 and
//   then the basis knots. Elsewhere a 64-ary search (two probes a lane, a
//   ballot a round) finishes the job. The basis, its divides and the slope
//   denominators are then computed once, with the denominators' reciprocals
//   where those are exact (powers of two: 1 on D3STN's span), so that every
//   element multiplies where it would divide, for the same bits (the
//   forward of a chunk whose segments all have them takes a branch-free
//   evaluation, chosen at the barrier that publishes the segments);
// - a thread takes one (row, query) pair for all D channels, and with D = 3
//   known at compile time it loads rows i, i+1 and i+2 of each of its pairs
//   (3 D consecutive values, 36 bytes) before any arithmetic;
// - the lag gradient g_q[l] = sum_{b,c} g[b,l,c] dH/dq[b,l,c] is one launch
//   (hermite_lag_grad_kernel): the derivative basis, the product with g and
//   the sum over rows and channels. Each CTA writes its partial sums once; the
//   last CTA to finish (an integer ticket) sums them in CTA order. The CTA
//   count comes from the shape, so the bits are the same on any card.
//
// Every product, quotient and sum of the evaluation is rounded on its own
// (never contracted into an FMA), in the plain version's order: queries out
// of range extrapolate the end cubic with coefficients of order frac^3,
// where a contracted FMA changes the cancellation by far more than a
// rounding step. The forward matches the plain version bit for bit. The lag
// gradient rounds each product g dH/dq as the plain version does and sums in
// float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 32;                 // rows of a CTA's block (a warp's lanes in the row sums)
constexpr int QC = 32;                 // queries located at once (a chunk)
constexpr int QW = QC / WARPS;         // queries of a chunk per warp
constexpr int PP = RB * QC / THREADS;  // (row, query) pairs of a thread per block, at most
// CTAs of a launch at most, the rest of the row blocks looping: one wave at
// two CTAs an SM, and the lag gradient's last CTA sums 8 partials a lane
constexpr int MAX_CTAS = 256;

// CTAs an SM must hold at once (__launch_bounds__): two in float32, so that
// up to 264 CTAs run in one wave; float64's chains take more registers
template <typename S>
constexpr int MIN_CTAS = sizeof(S) == 4 ? 2 : 1;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

// what a query needs for every row: its segment i, i2 = min(i + 2, T - 1),
// the four basis coefficients and the two slope denominators (with their
// reciprocals where those are exact)
template <typename S>
struct Seg {
  S c_p0, c_m0, c_p1, c_m1, den0, den1;
  S r0, r1;  // exact 1 / den0, 1 / den1, or 0 (exact_recip)
  int i, i2;
};

// the two query sets as one list: a's queries, then b's
template <typename S>
struct Queries {
  const S* a;
  const S* b;
  int la, n;
  __device__ __forceinline__ S operator[](int l) const { return l < la ? a[l] : b[l - la]; }
};

// first j in [0, n] with t[j] > q for nondecreasing t (torch.searchsorted(...,
// right=True)), for the QW queries q[k] of this warp: the answer a of query
// k lies in [lo[k], hi[k]] on entry (lo = hi: found) and is lo[k] on exit. A
// round probes 64 knots evenly spaced over [lo, hi], two a lane (probe j at
// lane j % 32); the first probe whose knot exceeds q bounds the answer to
// one spacing: ceil(log64(hi - lo + 1)) rounds. Probe p_j = lo + (j + 1) step
// - 1 has t[p_j] > q exactly when a <= p_j (a probe at or past hi counts as
// above q).
template <typename S>
__device__ __forceinline__ void upper_bound_warp(const S* __restrict__ t, const S (&q)[QW],
                                                 int (&lo)[QW], int (&hi)[QW]) {
  const int lane = threadIdx.x & 31;
  while (true) {
    bool more = false;
#pragma unroll
    for (int k = 0; k < QW; ++k) more |= hi[k] > lo[k];
    if (!more) break;  // lo and hi are the same in every lane
    bool gt[QW][2];
#pragma unroll
    for (int k = 0; k < QW; ++k) {  // every query's loads in flight before a ballot
      const int step = (hi[k] - lo[k] + 63) >> 6;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lo[k] + (lane + 32 * h + 1) * step - 1;
        gt[k][h] = hi[k] <= lo[k] || p >= hi[k] || t[p] > q[k];  // a finished query loads nothing
      }
    }
#pragma unroll
    for (int k = 0; k < QW; ++k) {
      if (hi[k] <= lo[k]) continue;
      const int step = (hi[k] - lo[k] + 63) >> 6;
      const unsigned m0 = __ballot_sync(0xffffffffu, gt[k][0]);
      const unsigned m1 = __ballot_sync(0xffffffffu, gt[k][1]);
      if ((m0 | m1) == 0u) {  // every knot of [lo, hi) is at or below q
        lo[k] = hi[k];
      } else {
        const int f = m0 ? __ffs(m0) - 1 : 32 + __ffs(m1) - 1;
        hi[k] = min(lo[k] + (f + 1) * step - 1, hi[k]);
        lo[k] = lo[k] + f * step;
      }
    }
  }
}

// 1 / den where that is exact (den = +-2^k, a normal number), else 0. x * (1 /
// den) is then x / den bit for bit: both round the same real number once.
__device__ __forceinline__ float exact_recip(float den) {
  const uint32_t b = __float_as_uint(den);
  const uint32_t e = (b >> 23) & 0xFFu;
  return (b & 0x7FFFFFu) == 0u && e != 0u && e != 0xFFu ? div(1.f, den) : 0.f;
}
__device__ __forceinline__ double exact_recip(double den) {
  const uint64_t b = (uint64_t)__double_as_longlong(den);
  const uint64_t e = (b >> 52) & 0x7FFull;
  return (b & 0xFFFFFFFFFFFFFull) == 0ull && e != 0ull && e != 0x7FFull ? div(1.0, den) : 0.0;
}

// x / y for the same bits with r = exact_recip(y): a product where r is not 0
template <typename S>
__device__ __forceinline__ S quot(S x, S y, S r) {
  return r != S(0) ? mul(x, r) : div(x, y);
}

// window knot w + j (j in [0, 64), per lane) of a window held as v0 = t[w +
// lane], v1 = t[w + 32 + lane]; every lane takes part
template <typename S>
__device__ __forceinline__ S window_knot(S v0, S v1, int j) {
  const S a = __shfl_sync(0xffffffffu, v0, j & 31);
  const S b = __shfl_sync(0xffffffffu, v1, j & 31);
  return j < 32 ? a : b;
}

// the segments of queries q0 .. q0 + lc - 1 -> seg[0 .. lc); the caller
// syncs. Warp w takes queries w, w + WARPS, ... at once. A query's answer is
// first looked for in a window of 64 consecutive knots around the index that
// linear interpolation between t[0] and t[n-1] guesses (the query and the two
// end knots load together, the window next): where the knots are evenly
// spaced, as D3STN's history span is, the window holds the answer and every
// knot the basis needs, so a query costs two dependent loads. Otherwise the
// 64-ary search takes over on the side of the window that holds the answer,
// and the basis knots are loaded. Lane k then computes the basis of the
// warp's k-th query, all of them at once. Returns false where the thread
// wrote a segment whose slope denominators lack exact reciprocals.
template <typename S>
__device__ __forceinline__ bool locate(const S* __restrict__ t, int n, Queries<S> qs, int q0,
                                       int lc, bool derivative, Seg<S>* seg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const S first = t[0], last = t[n - 1];
  S q[QW], v0[QW], v1[QW];
  int w[QW], lo[QW], hi[QW];
#pragma unroll
  for (int k = 0; k < QW; ++k) {
    const int l = warp + k * WARPS;
    q[k] = l < lc ? qs[q0 + l] : S(0);
  }
  // the guess needs no exact arithmetic: float, an approximate quotient
  const float scale = last > first ? __fdividef((float)(n - 1), (float)(last - first)) : 0.f;
#pragma unroll
  for (int k = 0; k < QW; ++k) {
    float g = (float)(q[k] - first) * scale;
    g = g >= 0.f ? fminf(g, (float)(n - 1)) : 0.f;  // NaN -> 0
    w[k] = max(0, min((int)g - 31, n - 64));
    v0[k] = w[k] + lane < n ? t[w[k] + lane] : S(0);
    v1[k] = w[k] + 32 + lane < n ? t[w[k] + 32 + lane] : S(0);
  }
#pragma unroll
  for (int k = 0; k < QW; ++k) {
    const bool live = warp + k * WARPS < lc;
    const unsigned m0 = __ballot_sync(0xffffffffu, w[k] + lane >= n || v0[k] > q[k]);
    const unsigned m1 = __ballot_sync(0xffffffffu, w[k] + 32 + lane >= n || v1[k] > q[k]);
    const int f = m0 ? __ffs(m0) - 1 : m1 ? 32 + __ffs(m1) - 1 : 64;
    if (!live) {
      lo[k] = hi[k] = 0;
    } else if (f == 64) {  // t[w + 63] <= q: the answer lies past the window
      lo[k] = w[k] + 64;
      hi[k] = n;
    } else if (f == 0 && w[k] > 0) {  // t[w] > q: before it
      lo[k] = 0;
      hi[k] = w[k];
    } else {
      lo[k] = hi[k] = w[k] + f;
    }
  }
  upper_bound_warp(t, q, lo, hi);
  // lane k: the warp's k-th query (its answer, window and knots i, i+1, i2)
  int a = 0, wk = 0;
  S ql = S(0);
#pragma unroll
  for (int k = 0; k < QW; ++k)
    if (lane == k) {
      a = lo[k];
      wk = w[k];
      ql = q[k];
    }
  const int i = min(max(a - 1, 0), n - 2);
  const int i2 = min(i + 2, n - 1);
  const bool in_window = i >= wk && i2 < wk + 64;
  S t0 = S(0), t1 = S(0), t2 = S(0);
#pragma unroll
  for (int k = 0; k < QW; ++k) {  // every lane takes part in every shuffle
    const S a0 = window_knot(v0[k], v1[k], i - wk);
    const S a1 = window_knot(v0[k], v1[k], i + 1 - wk);
    const S a2 = window_knot(v0[k], v1[k], i2 - wk);
    if (lane == k) {
      t0 = a0;
      t1 = a1;
      t2 = a2;
    }
  }
  const int l = warp + lane * WARPS;
  if (lane >= QW || l >= lc) return true;
  if (!in_window) {
    t0 = t[i];
    t1 = t[i + 1];
    t2 = t[i2];
  }
  Seg<S> s;
  s.den0 = sub(t1, t0);
  s.den1 = i2 > i + 1 ? sub(t2, t1) : s.den0;  // t[i2] - t[i2 - 1]
  s.r0 = exact_recip(s.den0);
  s.r1 = exact_recip(s.den1);
  const S h = t1 == t0 ? S(1) : s.den0;
  const S rh = t1 == t0 ? S(1) : s.r0;
  const S fx = quot(sub(ql, t0), h, rh);
  const S x2 = mul(fx, fx);
  if (derivative) {
    s.c_p0 = quot(sub(mul(S(6), x2), mul(S(6), fx)), h, rh);
    s.c_m0 = add(sub(mul(S(3), x2), mul(S(4), fx)), S(1));
    s.c_p1 = quot(add(mul(S(-6), x2), mul(S(6), fx)), h, rh);
    s.c_m1 = sub(mul(S(3), x2), mul(S(2), fx));
  } else {
    const S x3 = mul(x2, fx);
    s.c_p0 = add(sub(mul(S(2), x3), mul(S(3), x2)), S(1));
    s.c_m0 = mul(add(sub(x3, mul(S(2), x2)), fx), h);
    s.c_p1 = add(mul(S(-2), x3), mul(S(3), x2));
    s.c_m1 = mul(sub(x3, x2), h);
  }
  s.i = i;
  s.i2 = i2;
  seg[l] = s;
  return s.r0 != S(0) && s.r1 != S(0);
}

// the Hermite value (or derivative, by the basis in s) from rows i, i+1 and
// i+2 (p2; read only where i2 = i + 2) of one channel. EXACT: both slope
// denominators have exact reciprocals (for the same bits, products only: no
// branch between one element and the next)
template <bool EXACT, typename S>
__device__ __forceinline__ S hermite(const Seg<S>& s, S p0, S p1, S p2) {
  const S d0 = sub(p1, p0);
  const S d1 = s.i2 > s.i + 1 ? sub(p2, p1) : d0;
  const S m0 = EXACT ? mul(d0, s.r0) : quot(d0, s.den0, s.r0);
  const S m1 = EXACT ? mul(d1, s.r1) : quot(d1, s.den1, s.r1);
  S acc = mul(s.c_p0, p0);
  acc = add(acc, mul(s.c_m0, m0));
  acc = add(acc, mul(s.c_p1, p1));
  return add(acc, mul(s.c_m1, m1));
}

// a thread's pairs of one block: pair k is p = threadIdx.x + k THREADS of the
// block's RB x lc (row, query) pairs, queries fastest (row[k] = p / lc, ql[k]
// = p % lc; ql[k] = -1: no pair). With D a compile-time DC, every pair's 3 DC
// values are loaded before any arithmetic, so the loads of all pairs are in
// flight at once.
template <typename S, int DC>
struct Block {
  S v[PP][3][DC];
  int row[PP], ql[PP];

  __device__ __forceinline__ void load(const S* __restrict__ x, int t_len, const Seg<S>* seg,
                                       int64_t r0, int lc, int np) {
#pragma unroll
    for (int k = 0; k < PP; ++k) {
      const int p = threadIdx.x + k * THREADS;
      ql[k] = -1;
      if (p >= np) continue;
      row[k] = p / lc;
      ql[k] = p - row[k] * lc;
      const Seg<S>& s = seg[ql[k]];
      const S* xr = x + ((r0 + row[k]) * t_len + s.i) * DC;
      const bool far = s.i2 > s.i + 1;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        v[k][0][c] = xr[c];
        v[k][1][c] = xr[DC + c];
        v[k][2][c] = far ? xr[2 * DC + c] : S(0);
      }
    }
  }

  template <bool EXACT>
  __device__ __forceinline__ S value(const Seg<S>& s, int k, int c) const {
    return hermite<EXACT>(s, v[k][0][c], v[k][1][c], v[k][2][c]);
  }
};

// the forward's rows for the located chunk q0 .. q0 + lc - 1: CTA c takes
// the blocks of RB rows c, c + grid, ...; a thread the pairs threadIdx.x,
// threadIdx.x + THREADS, ... of a block. DC: D at compile time (0: d at run
// time, one pair after the other)
template <bool EXACT, typename S, int DC>
__device__ __forceinline__ void gather_rows(const S* __restrict__ x, int t_len, int d,
                                            const Seg<S>* seg, int q0, int lc, int la, int lb,
                                            int64_t rows, S* __restrict__ out_a,
                                            S* __restrict__ out_b) {
  for (int64_t r0 = (int64_t)blockIdx.x * RB; r0 < rows; r0 += (int64_t)gridDim.x * RB) {
    const int np = (int)min((int64_t)RB, rows - r0) * lc;
    if constexpr (DC > 0) {
      Block<S, DC> blk;
      blk.load(x, t_len, seg, r0, lc, np);
#pragma unroll
      for (int k = 0; k < PP; ++k) {
        if (blk.ql[k] < 0) continue;
        const int64_t r = r0 + blk.row[k];
        const int l = q0 + blk.ql[k];
        const Seg<S> s = seg[blk.ql[k]];
        S* o = l < la ? out_a + (r * la + l) * DC : out_b + (r * lb + (l - la)) * DC;
#pragma unroll
        for (int c = 0; c < DC; ++c) o[c] = blk.template value<EXACT>(s, k, c);
      }
    } else {
      for (int p = threadIdx.x; p < np; p += THREADS) {
        const int64_t r = r0 + p / lc;
        const int l = q0 + p % lc;
        const Seg<S> s = seg[p % lc];
        const S* xr = x + (r * t_len + s.i) * d;
        const bool far = s.i2 > s.i + 1;
        S* o = l < la ? out_a + (r * la + l) * d : out_b + (r * lb + (l - la)) * d;
        for (int c = 0; c < d; ++c)
          o[c] = hermite<EXACT>(s, xr[c], xr[d + c], far ? xr[2 * d + c] : S(0));
      }
    }
  }
}

// the lag gradient's rows for the located chunk (as gather_rows): red[p] +=
// pair p's sum over its channels of g dH/dq, in float64. Its slopes always
// take quot's branch: a branch-free second instantiation (as gather_rows
// has) spilled at two CTAs an SM and was no faster
template <typename S, int DC>
__device__ __forceinline__ void lag_grad_rows(const S* __restrict__ x, int t_len, int d,
                                              const Seg<S>* seg, int q0, int lc, int la, int lb,
                                              int64_t rows, const S* __restrict__ ga,
                                              const S* __restrict__ gb, double* red) {
  for (int64_t r0 = (int64_t)blockIdx.x * RB; r0 < rows; r0 += (int64_t)gridDim.x * RB) {
    const int np = (int)min((int64_t)RB, rows - r0) * lc;
    if constexpr (DC > 0) {
      Block<S, DC> blk;
      blk.load(x, t_len, seg, r0, lc, np);
      S gv[PP][DC];
#pragma unroll
      for (int k = 0; k < PP; ++k) {  // the cotangent's loads beside the series'
        if (blk.ql[k] < 0) continue;
        const int64_t r = r0 + blk.row[k];
        const int l = q0 + blk.ql[k];
        const S* g = l < la ? ga + (r * la + l) * DC : gb + (r * lb + (l - la)) * DC;
#pragma unroll
        for (int c = 0; c < DC; ++c) gv[k][c] = g[c];
      }
#pragma unroll
      for (int k = 0; k < PP; ++k) {
        if (blk.ql[k] < 0) continue;
        const Seg<S> s = seg[blk.ql[k]];
        double sum = 0.0;
#pragma unroll
        for (int c = 0; c < DC; ++c)
          sum += (double)mul(gv[k][c], blk.template value<false>(s, k, c));
        red[threadIdx.x + k * THREADS] += sum;
      }
    } else {
      for (int p = threadIdx.x; p < np; p += THREADS) {
        const int64_t r = r0 + p / lc;
        const int l = q0 + p % lc;
        const Seg<S> s = seg[p % lc];
        const S* xr = x + (r * t_len + s.i) * d;
        const bool far = s.i2 > s.i + 1;
        const S* g = l < la ? ga + (r * la + l) * d : gb + (r * lb + (l - la)) * d;
        double sum = 0.0;
        for (int c = 0; c < d; ++c)
          sum += (double)mul(g[c], hermite<false>(s, xr[c], xr[d + c], far ? xr[2 * d + c] : S(0)));
        red[p] += sum;
      }
    }
  }
}

}  // namespace

// out_a [rows, la, D] and out_b [rows, lb, D]: the series x [rows, T, D] at
// the queries qa [la] and qb [lb] (lb = 0: one set), QC queries at a time.
template <typename S, int DC>
__global__ void __launch_bounds__(THREADS, MIN_CTAS<S>) hermite_gather_kernel(
    const S* __restrict__ x, const S* __restrict__ t, const S* __restrict__ qa,
    const S* __restrict__ qb, S* __restrict__ out_a, S* __restrict__ out_b, int64_t rows,
    int t_len, int d, int la, int lb, int derivative) {
  __shared__ Seg<S> seg[QC];
  const Queries<S> qs{qa, qb, la, la + lb};
  for (int q0 = 0; q0 < qs.n; q0 += QC) {
    const int lc = min(QC, qs.n - q0);
    if (q0 > 0) __syncthreads();  // the last chunk's rows are done with seg
    // the barrier that publishes seg tells whether every segment is exact
    if (__syncthreads_and(locate(t, t_len, qs, q0, lc, derivative != 0, seg)))
      gather_rows<true, S, DC>(x, t_len, d, seg, q0, lc, la, lb, rows, out_a, out_b);
    else
      gather_rows<false, S, DC>(x, t_len, d, seg, q0, lc, la, lb, rows, out_a, out_b);
  }
}

// gq_a [la], gq_b [lb]: g_q[l] = sum over rows and channels of g[r, l, c]
// dH/dq[r, l, c] for the two query sets (ga [rows, la, D], gb [rows, lb,
// D]). Each product is rounded as the plain version's g * dH; the sums run
// in float64: a pair's over its channels and over the CTA's row blocks in
// order (red[p]), the CTA's RB rows by a fixed butterfly over a warp's
// lanes into partial[l, cta], then, in the last CTA to take a ticket, the
// CTAs (lane j: CTAs j, j + 32, ... in order, then the butterfly). The last
// CTA sets the ticket back to 0.
template <typename S, int DC>
__global__ void __launch_bounds__(THREADS, MIN_CTAS<S>) hermite_lag_grad_kernel(
    const S* __restrict__ x, const S* __restrict__ t, const S* __restrict__ qa,
    const S* __restrict__ qb, const S* __restrict__ ga, const S* __restrict__ gb,
    S* __restrict__ gq_a, S* __restrict__ gq_b, double* __restrict__ partial,
    unsigned* __restrict__ ticket, int64_t rows, int t_len, int d, int la, int lb) {
  static_assert(RB == 32, "a warp's lanes sum the RB rows of a block");
  __shared__ Seg<S> seg[QC];
  __shared__ double red[RB * QC];
  __shared__ bool last;
  const Queries<S> qs{qa, qb, la, la + lb};
  const int lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < qs.n; q0 += QC) {
    const int lc = min(QC, qs.n - q0);
    if (q0 > 0) __syncthreads();
    locate(t, t_len, qs, q0, lc, true, seg);
    for (int p = threadIdx.x; p < RB * lc; p += THREADS) red[p] = 0.0;  // its thread's pairs
    __syncthreads();
    lag_grad_rows<S, DC>(x, t_len, d, seg, q0, lc, la, lb, rows, ga, gb, red);
    __syncthreads();
    for (int l = threadIdx.x >> 5; l < lc; l += WARPS) {
      double sum = red[lane * lc + l];  // lane j: row j of the block
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) partial[(int64_t)(q0 + l) * gridDim.x + blockIdx.x] = sum;
    }
  }
  // the CTA's partials (after the barrier) visible to every CTA before the
  // ticket is taken: one fence, cumulative over what the barrier ordered
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // lane j: CTAs j, j + 32, ... of a query, every load in flight before the sum
  constexpr int PER_LANE = MAX_CTAS / 32;
  for (int l = threadIdx.x >> 5; l < qs.n; l += WARPS) {
    double v[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < (int)gridDim.x ? __ldcg(&partial[(int64_t)l * gridDim.x + c]) : 0.0;
    }
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) sum += v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      if (l < la)
        gq_a[l] = (S)sum;
      else
        gq_b[l - la] = (S)sum;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

namespace {

// CTAs of a launch: one per block of RB rows, at most MAX_CTAS (from the
// shape alone, never from the card)
int ctas(int64_t rows) {
  const int64_t blocks = (rows + RB - 1) / RB;
  return (int)(blocks < 1 ? 1 : blocks < MAX_CTAS ? blocks : MAX_CTAS);
}

template <typename S, int DC>
void gather(const void* x, const void* t, const void* qa, const void* qb, void* out_a, void* out_b,
            int64_t rows, int t_len, int d, int la, int lb, int derivative, cudaStream_t stream) {
  hermite_gather_kernel<S, DC><<<ctas(rows), THREADS, 0, stream>>>(
      (const S*)x, (const S*)t, (const S*)qa, (const S*)qb, (S*)out_a, (S*)out_b, rows, t_len, d,
      la, lb, derivative);
}

template <typename S>
int launch_gather(const void* x, const void* t, const void* qa, const void* qb, void* out_a,
                  void* out_b, int64_t rows, int t_len, int d, int la, int lb, int derivative,
                  void* stream) {
  if (rows == 0 || la + lb == 0 || d == 0) return 0;
  if (d == 3)  // D3STN's history: value, day of week, time of day
    gather<S, 3>(x, t, qa, qb, out_a, out_b, rows, t_len, d, la, lb, derivative,
                 (cudaStream_t)stream);
  else
    gather<S, 0>(x, t, qa, qb, out_a, out_b, rows, t_len, d, la, lb, derivative,
                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename S, int DC>
void lag_grad(const void* x, const void* t, const void* qa, const void* qb, const void* ga,
              const void* gb, void* gq_a, void* gq_b, void* partial, void* ticket, int64_t rows,
              int t_len, int d, int la, int lb, cudaStream_t stream) {
  hermite_lag_grad_kernel<S, DC><<<ctas(rows), THREADS, 0, stream>>>(
      (const S*)x, (const S*)t, (const S*)qa, (const S*)qb, (const S*)ga, (const S*)gb, (S*)gq_a,
      (S*)gq_b, (double*)partial, (unsigned*)ticket, rows, t_len, d, la, lb);
}

template <typename S>
int launch_lag_grad(const void* x, const void* t, const void* qa, const void* qb, const void* ga,
                    const void* gb, void* gq_a, void* gq_b, void* partial, void* ticket,
                    int64_t rows, int t_len, int d, int la, int lb, void* stream) {
  if (la + lb == 0) return 0;
  if (d == 3)
    lag_grad<S, 3>(x, t, qa, qb, ga, gb, gq_a, gq_b, partial, ticket, rows, t_len, d, la, lb,
                   (cudaStream_t)stream);
  else
    lag_grad<S, 0>(x, t, qa, qb, ga, gb, gq_a, gq_b, partial, ticket, rows, t_len, d, la, lb,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

// CTAs of a lag-gradient launch: its partial sums hold this many x la + lb
extern "C" int pxt_hermite_ctas(int64_t rows) { return ctas(rows); }

extern "C" int pxt_hermite_gather_f32(const void* x, const void* t, const void* qa, const void* qb,
                                      void* out_a, void* out_b, int64_t rows, int t_len, int d,
                                      int la, int lb, int derivative, void* stream) {
  return launch_gather<float>(x, t, qa, qb, out_a, out_b, rows, t_len, d, la, lb, derivative,
                              stream);
}

extern "C" int pxt_hermite_gather_f64(const void* x, const void* t, const void* qa, const void* qb,
                                      void* out_a, void* out_b, int64_t rows, int t_len, int d,
                                      int la, int lb, int derivative, void* stream) {
  return launch_gather<double>(x, t, qa, qb, out_a, out_b, rows, t_len, d, la, lb, derivative,
                               stream);
}

extern "C" int pxt_hermite_lag_grad_f32(const void* x, const void* t, const void* qa,
                                        const void* qb, const void* ga, const void* gb, void* gq_a,
                                        void* gq_b, void* partial, void* ticket, int64_t rows,
                                        int t_len, int d, int la, int lb, void* stream) {
  return launch_lag_grad<float>(x, t, qa, qb, ga, gb, gq_a, gq_b, partial, ticket, rows, t_len,
                                d, la, lb, stream);
}

extern "C" int pxt_hermite_lag_grad_f64(const void* x, const void* t, const void* qa,
                                        const void* qb, const void* ga, const void* gb, void* gq_a,
                                        void* gq_b, void* partial, void* ticket, int64_t rows,
                                        int t_len, int d, int la, int lb, void* stream) {
  return launch_lag_grad<double>(x, t, qa, qb, ga, gb, gq_a, gq_b, partial, ticket, rows, t_len,
                                 d, la, lb, stream);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
