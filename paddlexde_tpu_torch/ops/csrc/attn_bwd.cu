// Fused temporal-context attention block (backward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/attn_pallas.py
// (_bwd_kernel, launched by _call_bwd in the custom VJP of
// fused_temporal_attention). Per (batch, node) row, for the forward
//
//   q = conv(mq; Wq, bq)  k = conv(mk; Wk, bk)  v = conv(vs; Wv, bv)
//   p = softmax(q_h k_h^T / sqrt(dh) [+ finfo(f32).min above the diagonal])
//   x_attn = p v          y = conv(x_attn; Wo, bo, same padding)
//
// and the output cotangent g, it gives dmq, dmk, dvs and the eight weight
// and bias gradients:
//
//   dx_attn = convT(g; Wo)           (conv with reversed, transposed taps)
//   dp = dx_attn_h v_h^T, dv_h = p^T dx_attn_h, ds = p (.) (dp - rowsum(dp p))
//   dq_h = ds k_h / sqrt(dh),  dk_h = ds^T q_h / sqrt(dh)
//   dmq = convT(dq; Wq), dmk = convT(dk; Wk), dvs = convT(dv; Wv)
//   dW[j] = sum_rows,t xpad[t + j]^T d(out)[t],  db = sum_rows,t d(out)[t]
//
// for the pairs (mq, dq), (mk, dk), (vs, dv), (x_attn, g).
//
// Design: four kernels per call.
//
// 1. attn_bwd_wt_kernel writes the four weight banks with their taps
//    reversed and each tap transposed, W'[j] = W[K-1-j]^T, so the input
//    gradients are ordinary convs (left pad K-1-pad_left) and share the
//    forward's conv loop.
// 2. attn_bwd_row_kernel, in the register-tiled style of attn.cu's D3STN
//    kernel: one warp per (batch, node) row, 4 rows per CTA; lane l owns the
//    features FPL*l .. FPL*l+FPL-1 for all 12 steps; weight chunks stream
//    through shared memory (cp.async, double buffered). Seven convs per row
//    (v, q, k, dx_attn, dmq, dmk, dvs); the attention core in per-warp
//    shared tiles. It writes dmq, dmk, dvs and the four pre-conv tensors the
//    weight gradients need (x_attn, dq, dk, dv).
// 3. attn_bwd_dw_kernel: the weight gradients are reduction products over
//    R = rows * 12 (row, t) pairs. One CTA per (split of R, weight, tap)
//    computes a D x D tile (16 x 16 threads, an 8 x 8 register tile each at
//    D = 128) over its split and writes it as a partial; the tap-0 CTAs also
//    write the bias partials.
// 4. attn_bwd_sum_kernel sums the partials of the splits in split order.
//
// The TPU kernel zeroes the weight gradients at program (0, 0) and adds to
// them with += across its sequential grid. Here each partial is written
// once and summed in a fixed order: no atomics, the same bits from run to
// run.
//
// Bound: operations (eleven conv-sized products per row, 2 K D^2 T flops
// each, in float32 on the CUDA cores), against 7 T D floats moved per row.
// The pre-conv tensors add 8 T D floats per row of traffic. Shapes: T = 12,
// K = 3, dh = 16, D = 128 (H = 8) or D = 64 (H = 4), and D3STN's three flag
// sets (encoder self, decoder masked self, decoder source attention).

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 12, K = 3, DH = 16;
constexpr int WARPS = 4;  // rows per CTA
constexpr int CC = 8;     // input channels per weight chunk
constexpr int PAD_SAME = (K - 1) / 2;

template <int D>
struct Smem {
  static constexpr int H = D / DH;
  float x[WARPS][T][D];       // conv input tile
  float t[WARPS][T][D];       // v, then dv
  float p[WARPS][H][T][T];    // softmax
  float dp[WARPS][H][T][T];   // dP, then dS
  float w[2][CC][K][D];       // weight chunks: [input channel][tap][output]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldv(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ldv(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void stv(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stv(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// W [K, D, D] (tap, input, output) -> s.w[buf][cc][tap][:] for one chunk
template <int D>
__device__ __forceinline__ void load_chunk(Smem<D>& s, const float* __restrict__ w, int chunk,
                                           int buf) {
  constexpr int kUnits = CC * K * (D / 4);
  for (int u = threadIdx.x; u < kUnits; u += blockDim.x) {
    const int q = u % (D / 4);
    const int r = u / (D / 4);
    const int tap = r % K;
    const int cc = r / K;
    cp_async16(&s.w[buf][cc][tap][q * 4], w + ((int64_t)tap * D + chunk * CC + cc) * D + q * 4);
  }
}

// acc[t][e] = [bias +] sum_{tap, c} in[t + tap - PADL][c] W[tap][c][FPL lane + e]
// over the warp's [T, D] tile `in` in shared memory (zero outside [0, T)).
// Every thread of the CTA calls it; it ends with a CTA barrier.
template <int D, int PADL>
__device__ __forceinline__ void conv(Smem<D>& s, const float (*in)[D],
                                     const float* __restrict__ w,
                                     const float* __restrict__ bias, int lane,
                                     float (&acc)[T][D / 32]) {
  constexpr int FPL = D / 32;
  constexpr int CHUNKS = D / CC;
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < FPL; ++e) acc[t][e] = 0.f;
  load_chunk<D>(s, w, 0, 0);
  cp_async_commit();
  for (int ci = 0; ci < CHUNKS; ++ci) {
    if (ci + 1 < CHUNKS) load_chunk<D>(s, w, ci + 1, (ci + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int buf = ci & 1;
#pragma unroll
    for (int cq = 0; cq < CC; cq += 4) {
      float wv[4][K][FPL];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int tap = 0; tap < K; ++tap) ldv(&s.w[buf][cq + cc][tap][lane * FPL], wv[cc][tap]);
      const int c = ci * CC + cq;
#pragma unroll
      for (int src = 0; src < T; ++src) {
        const float4 xv = *reinterpret_cast<const float4*>(&in[src][c]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int tap = 0; tap < K; ++tap) {
          const int t = src - tap + PADL;
          if (t >= 0 && t < T) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
#pragma unroll
              for (int e = 0; e < FPL; ++e) acc[t][e] = fmaf(xs[cc], wv[cc][tap][e], acc[t][e]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (bias != nullptr) {
    float b[FPL];
    ldv(bias + lane * FPL, b);
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < FPL; ++e) acc[t][e] += b[e];
  }
}

// the lane's features of a [T, D] row of global memory into a warp tile
// (zeros past the last row)
template <int D>
__device__ __forceinline__ void stage(float (*dst)[D], const float* __restrict__ src, int64_t row,
                                      bool live, int lane) {
  constexpr int FPL = D / 32;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float v[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) v[e] = 0.f;
    if (live) ldv(src + (row * T + t) * D + lane * FPL, v);
    stv(&dst[t][lane * FPL], v);
  }
  __syncwarp();
}

template <int D>
__device__ __forceinline__ void put_tile(float (*dst)[D], const float (&v)[T][D / 32], int lane) {
#pragma unroll
  for (int t = 0; t < T; ++t) stv(&dst[t][lane * (D / 32)], v[t]);
}

template <int D>
__device__ __forceinline__ void put_global(float* __restrict__ dst, int64_t row, bool live,
                                           const float (&v)[T][D / 32], int lane) {
  if (!live) return;
#pragma unroll
  for (int t = 0; t < T; ++t) stv(dst + (row * T + t) * D + lane * (D / 32), v[t]);
}

// sum over the lanes of one head (LPH consecutive lanes)
template <int LPH>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 1; o < LPH; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Ptrs {
  const float *mq, *mk, *vs, *bq, *bk, *bv, *g;
  const float* wt;  // [4][K][D][D]: q, k, v, o banks, taps reversed and transposed
  const float *wq, *wk, *wv, *wo;
  float *dmq, *dmk, *dvs, *xatt, *dq, *dk, *dv;
};

template <int D, bool CQ, bool CKV, bool MASK>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_row_kernel(Ptrs io, int64_t rows) {
  constexpr int FPL = D / 32;
  constexpr int LPH = DH / FPL;  // lanes per head
  constexpr int PQ = CQ ? K - 1 : PAD_SAME;
  constexpr int PKV = CKV ? K - 1 : PAD_SAME;
  constexpr int64_t WB = (int64_t)K * D * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = row < rows;
  const int head = lane / LPH;
  const int qd = lane % LPH;
  const float scale = 1.f / sqrtf((float)DH);
  float (*sx)[D] = s.x[warp];
  float (*st)[D] = s.t[warp];
  float (*sp)[T][T] = s.p[warp];
  float (*sdp)[T][T] = s.dp[warp];

  float a[T][FPL], q[T][FPL], k[T][FPL];
  // v -> s.t
  stage<D>(sx, io.vs, row, live, lane);
  conv<D, PKV>(s, sx, io.wv, io.bv, lane, a);
  put_tile<D>(st, a, lane);
  stage<D>(sx, io.mq, row, live, lane);
  conv<D, PQ>(s, sx, io.wq, io.bq, lane, q);
  stage<D>(sx, io.mk, row, live, lane);
  conv<D, PKV>(s, sx, io.wk, io.bk, lane, k);

  // scores of this lane's head, then the row softmax (rows split over the
  // head's lanes)
#pragma unroll
  for (int tq = 0; tq < T; ++tq) {
#pragma unroll
    for (int tk = 0; tk < T; ++tk) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < FPL; ++e) d = fmaf(q[tq][e], k[tk][e], d);
      d = head_sum<LPH>(d) * scale;
      if (MASK && tk > tq) d += -FLT_MAX;
      if (qd == 0) sp[head][tq][tk] = d;
    }
  }
  __syncwarp();
  for (int r = qd; r < T; r += LPH) {
    float* prow = sp[head][r];
    float mx = prow[0];
    for (int j = 1; j < T; ++j) mx = fmaxf(mx, prow[j]);
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      prow[j] = expf(prow[j] - mx);
      sum += prow[j];
    }
    for (int j = 0; j < T; ++j) prow[j] = prow[j] / sum;
  }
  __syncwarp();

  // x_attn = P V (the out conv's input, for its weight gradient)
  if (live) {
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      float o[FPL];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
      for (int tk = 0; tk < T; ++tk) {
        float vv[FPL];
        ldv(&st[tk][lane * FPL], vv);
        const float pw = sp[head][tq][tk];
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, vv[e], o[e]);
      }
      stv(io.xatt + (row * T + tq) * D + lane * FPL, o);
    }
  }

  // dx_attn = convT(g; Wo)
  stage<D>(sx, io.g, row, live, lane);
  conv<D, K - 1 - PAD_SAME>(s, sx, io.wt + 3 * WB, nullptr, lane, a);

  // dP = dx_attn V^T per head
#pragma unroll
  for (int tk = 0; tk < T; ++tk) {
    float vv[FPL];
    ldv(&st[tk][lane * FPL], vv);
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < FPL; ++e) d = fmaf(a[tq][e], vv[e], d);
      d = head_sum<LPH>(d);
      if (qd == 0) sdp[head][tq][tk] = d;
    }
  }
  // dV = P^T dx_attn, over v in s.t (each lane rewrites only its features)
#pragma unroll
  for (int tk = 0; tk < T; ++tk) {
    float o[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      const float pw = sp[head][tq][tk];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, a[tq][e], o[e]);
    }
    stv(&st[tk][lane * FPL], o);
    if (live) stv(io.dv + (row * T + tk) * D + lane * FPL, o);
  }
  __syncwarp();
  // dS = P (.) (dP - rowsum(dP P)), in place of dP
  for (int r = qd; r < T; r += LPH) {
    float* drow = sdp[head][r];
    const float* prow = sp[head][r];
    float dot = 0.f;
    for (int j = 0; j < T; ++j) dot = fmaf(drow[j], prow[j], dot);
    for (int j = 0; j < T; ++j) drow[j] = prow[j] * (drow[j] - dot);
  }
  __syncwarp();

  // dQ = dS K / sqrt(dh) -> the conv tile; dK = dS^T Q / sqrt(dh) -> a
#pragma unroll
  for (int tq = 0; tq < T; ++tq) {
    float o[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int tk = 0; tk < T; ++tk) {
      const float dsv = sdp[head][tq][tk];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = fmaf(dsv, k[tk][e], o[e]);
    }
#pragma unroll
    for (int e = 0; e < FPL; ++e) o[e] *= scale;
    stv(&sx[tq][lane * FPL], o);
    if (live) stv(io.dq + (row * T + tq) * D + lane * FPL, o);
  }
#pragma unroll
  for (int tk = 0; tk < T; ++tk) {
#pragma unroll
    for (int e = 0; e < FPL; ++e) a[tk][e] = 0.f;
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      const float dsv = sdp[head][tq][tk];
#pragma unroll
      for (int e = 0; e < FPL; ++e) a[tk][e] = fmaf(dsv, q[tq][e], a[tk][e]);
    }
#pragma unroll
    for (int e = 0; e < FPL; ++e) a[tk][e] *= scale;
  }
  put_global<D>(io.dk, row, live, a, lane);

  // the input convs' input gradients
  conv<D, K - 1 - PQ>(s, sx, io.wt + 0 * WB, nullptr, lane, q);
  put_global<D>(io.dmq, row, live, q, lane);
  __syncwarp();
  put_tile<D>(sx, a, lane);
  conv<D, K - 1 - PKV>(s, sx, io.wt + 1 * WB, nullptr, lane, q);
  put_global<D>(io.dmk, row, live, q, lane);
  conv<D, K - 1 - PKV>(s, st, io.wt + 2 * WB, nullptr, lane, q);
  put_global<D>(io.dvs, row, live, q, lane);
}

// wt[i][j][c][f] = W_i[K-1-j][f][c] for the banks i = q, k, v, o
template <int D>
__global__ void attn_bwd_wt_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                                   const float* __restrict__ wv, const float* __restrict__ wo,
                                   float* __restrict__ wt) {
  constexpr int64_t BANK = (int64_t)K * D * D;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * BANK) return;
  const int i = (int)(idx / BANK);
  const int64_t r = idx - i * BANK;
  const int j = (int)(r / (D * D));
  const int c = (int)((r / D) % D);
  const int f = (int)(r % D);
  const float* w = i == 0 ? wq : i == 1 ? wk : i == 2 ? wv : wo;
  wt[idx] = w[((int64_t)(K - 1 - j) * D + f) * D + c];
}

struct DwArgs {
  const float* x[4];  // conv inputs: mq, mk, vs, x_attn
  const float* g[4];  // their output gradients: dq, dk, dv, g
  int padl[4];
};

constexpr int KS = 16;  // (row, t) pairs per shared-memory step

// part[split][(i K + j) D D + c D + f] = sum over the split's pairs of
// xpad_i[t + j][c] g_i[t][f]; the tap-0 CTAs also write
// part[split][4 K D D + i D + f] = sum of g_i[t][f].
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_dw_kernel(DwArgs args, int64_t pairs, int64_t chunk, float* __restrict__ part) {
  constexpr int NS = D / 64;  // float4 slices per thread and dimension
  constexpr int TM = 4 * NS;  // register tile TM x TM
  constexpr int64_t L = 4 * (int64_t)K * D * D + 4 * D;
  __shared__ __align__(16) float sa[KS][D];
  __shared__ __align__(16) float sb[KS][D];
  const int split = blockIdx.x;
  const int wi = blockIdx.y / K;
  const int tap = blockIdx.y % K;
  const float* __restrict__ X = args.x[wi];
  const float* __restrict__ G = args.g[wi];
  const int shift = tap - args.padl[wi];
  const int64_t p0 = split * chunk;
  const int64_t p1 = p0 + chunk < pairs ? p0 + chunk : pairs;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool bias_row = tap == 0 && ty == 0;

  float acc[TM][TM], bacc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  }
  for (int64_t pb = p0; pb < p1; pb += KS) {
    __syncthreads();
    for (int u = threadIdx.x; u < KS * (D / 4); u += blockDim.x) {
      const int kk = u / (D / 4);
      const int qq = u - kk * (D / 4);
      const int64_t p = pb + kk;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      if (p < p1) {
        const int64_t r = p / T;
        const int ts = (int)(p - r * T) + shift;
        bv = *reinterpret_cast<const float4*>(G + p * D + qq * 4);
        if (ts >= 0 && ts < T) av = *reinterpret_cast<const float4*>(X + (r * T + ts) * D + qq * 4);
      }
      *reinterpret_cast<float4*>(&sa[kk][qq * 4]) = av;
      *reinterpret_cast<float4*>(&sb[kk][qq * 4]) = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      float af[TM], bf[TM];
#pragma unroll
      for (int h = 0; h < NS; ++h) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sa[kk][h * 64 + ty * 4]);
        const float4 g4 = *reinterpret_cast<const float4*>(&sb[kk][h * 64 + tx * 4]);
        af[4 * h] = x4.x; af[4 * h + 1] = x4.y; af[4 * h + 2] = x4.z; af[4 * h + 3] = x4.w;
        bf[4 * h] = g4.x; bf[4 * h + 1] = g4.y; bf[4 * h + 2] = g4.z; bf[4 * h + 3] = g4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      if (bias_row) {
#pragma unroll
        for (int j = 0; j < TM; ++j) bacc[j] += bf[j];
      }
    }
  }

  float* out = part + split * L + (int64_t)(wi * K + tap) * D * D;
#pragma unroll
  for (int hi = 0; hi < NS; ++hi)
#pragma unroll
    for (int ei = 0; ei < 4; ++ei) {
      const int c = hi * 64 + ty * 4 + ei;
#pragma unroll
      for (int hj = 0; hj < NS; ++hj)
        *reinterpret_cast<float4*>(out + (int64_t)c * D + hj * 64 + tx * 4) =
            make_float4(acc[4 * hi + ei][4 * hj], acc[4 * hi + ei][4 * hj + 1],
                        acc[4 * hi + ei][4 * hj + 2], acc[4 * hi + ei][4 * hj + 3]);
    }
  if (bias_row) {
    float* ob = part + split * L + 4 * (int64_t)K * D * D + wi * D;
#pragma unroll
    for (int hj = 0; hj < NS; ++hj)
      *reinterpret_cast<float4*>(ob + hj * 64 + tx * 4) =
          make_float4(bacc[4 * hj], bacc[4 * hj + 1], bacc[4 * hj + 2], bacc[4 * hj + 3]);
  }
}

// out[i] = sum over the splits, in split order, of part[split][i]
__global__ void attn_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int64_t len, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * len + i];
  out[i] = s;
}

template <int D>
int64_t scratch_floats(int64_t rows, int splits) {
  return 4 * (int64_t)K * D * D + 4 * rows * T * D + splits * (4 * (int64_t)K * D * D + 4 * D);
}

template <int D, bool CQ, bool CKV, bool MASK>
int launch_rows(const Ptrs& a, int64_t rows, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_row_kernel<D, CQ, CKV, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + WARPS - 1) / WARPS;
  attn_bwd_row_kernel<D, CQ, CKV, MASK><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* const* p, void* const* out, float* scratch, int64_t rows, int splits,
           int causal_q, int causal_kv, cudaStream_t stream) {
  constexpr int64_t BANK = (int64_t)K * D * D;
  const int64_t act = rows * T * D;
  float* wt = scratch;
  float* pre = wt + 4 * BANK;  // x_attn, dq, dk, dv: [rows, T, D] each
  float* part = pre + 4 * act;
  Ptrs a;
  a.mq = (const float*)p[0]; a.mk = (const float*)p[1]; a.vs = (const float*)p[2];
  a.wq = (const float*)p[3]; a.bq = (const float*)p[4];
  a.wk = (const float*)p[5]; a.bk = (const float*)p[6];
  a.wv = (const float*)p[7]; a.bv = (const float*)p[8];
  a.wo = (const float*)p[9];
  a.g = (const float*)p[11];
  a.wt = wt;
  a.dmq = (float*)out[0]; a.dmk = (float*)out[1]; a.dvs = (float*)out[2];
  a.xatt = pre; a.dq = pre + act; a.dk = pre + 2 * act; a.dv = pre + 3 * act;

  attn_bwd_wt_kernel<D><<<(unsigned)((4 * BANK + 255) / 256), 256, 0, stream>>>(
      a.wq, a.wk, a.wv, a.wo, wt);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  if (!causal_q)
    code = launch_rows<D, false, false, false>(a, rows, stream);
  else if (causal_kv)
    code = launch_rows<D, true, true, true>(a, rows, stream);
  else
    code = launch_rows<D, true, false, false>(a, rows, stream);
  if (code != 0) return code;

  DwArgs args;
  args.x[0] = a.mq; args.x[1] = a.mk; args.x[2] = a.vs; args.x[3] = a.xatt;
  args.g[0] = a.dq; args.g[1] = a.dk; args.g[2] = a.dv; args.g[3] = a.g;
  const int pq = causal_q ? K - 1 : PAD_SAME;
  const int pkv = causal_kv ? K - 1 : PAD_SAME;
  args.padl[0] = pq; args.padl[1] = pkv; args.padl[2] = pkv; args.padl[3] = PAD_SAME;
  const int64_t pairs = rows * T;
  const int64_t chunk = (pairs + splits - 1) / splits;
  attn_bwd_dw_kernel<D><<<dim3(splits, 4 * K), 256, 0, stream>>>(args, pairs, chunk, part);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  const int64_t len = 4 * BANK + 4 * D;
  attn_bwd_sum_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      part, (float*)out[3], len, splits);
  return (int)cudaGetLastError();
}

bool flags_ok(int causal_q, int causal_kv, int is_mask) {
  return (!causal_q && !causal_kv && !is_mask) || (causal_q && causal_kv && is_mask) ||
         (causal_q && !causal_kv && !is_mask);
}

}  // namespace

extern "C" int64_t pxt_attn_bwd_scratch_floats(int64_t rows, int splits, int d) {
  if (d == 128) return scratch_floats<128>(rows, splits);
  if (d == 64) return scratch_floats<64>(rows, splits);
  return -1;
}

// p: the 12 inputs mq, mk, vs, wq, bq, wk, bk, wv, bv, wo, bo, g (all
// [rows, 12, d] or the conv banks); out: dmq, dmk, dvs and one buffer of
// 4 K d d + 4 d floats: dWq, dWk, dWv, dWo, then dbq, dbk, dbv, dbo.
extern "C" int pxt_attn_bwd_f32(const void* const* p, void* const* out, void* scratch,
                                int64_t rows, int splits, int d, int causal_q, int causal_kv,
                                int is_mask, void* stream) {
  if (rows <= 0 || splits <= 0 || !flags_ok(causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch<128>(p, out, (float*)scratch, rows, splits, causal_q, causal_kv, s);
  if (d == 64) return launch<64>(p, out, (float*)scratch, rows, splits, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
