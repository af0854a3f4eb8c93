// Fused temporal-context attention block (backward) in bfloat16, for Hopper
// (sm_90a).
//
// Replaces the bfloat16 form (dtype_name="bfloat16") of the Pallas TPU kernel
// paddlexde_tpu/ops/attn_pallas.py (_bwd_kernel with its block-diagonal
// middle, launched by _call_bwd in the custom VJP of
// fused_temporal_attention). Per (batch, node) row and the output cotangent
// g (bfloat16), with the TPU kernel's rounding points:
//
//   q, k, v = conv(mq; Wq, bq), conv(mk; ...), conv(vs; ...)   as the forward
//             K4 bf16: bf16(bf16(sum_j bf16(x) bf16(W[j])) + bf16(b))
//   p       = exp(s - max over every head of the query step) / sum over the
//             head, s = q_h k_h^T / sqrt(dh) [+ finfo(f32).min above the
//             diagonal], all float32; x_attn = bf16(bf16(p) v_h)
//   dWo, dbo  from bf16(x_attn) and g;  dx_attn = sum_j g bf16(Wo[K-1-j])^T
//             (float32 sums, kept float32)
//   dv_h = p^T dx_attn_h, dp = dx_attn_h v_h^T, ds = p (.) (dp - rowsum(dp p))
//   / sqrt(dh), dq_h = ds k_h, dk_h = ds^T q_h                    (float32)
//   dq, dk, dv rounded to bfloat16 where they enter products:
//   dW = sum_rows,t bf16(x)pad[t + j]^T bf16(d)[t], db = sum of bf16(d)
//   dmq = convT(bf16(dq); bf16(Wq)), dmk, dvs likewise      (float32 sums)
//
// for the pairs (mq, dq), (mk, dk), (vs, dv), (x_attn, g). Every product has
// bfloat16 operands, exact in float32, so no 3xTF32 is needed anywhere.
//
// Bound: operations. Eleven conv-sized products per row (2 K D^2 T flops
// each) are 98% of the work; they run on the tensor cores in bfloat16
// (wgmma m64nDk16, RS form, tc_bf16.cuh), the attention core on the CUDA
// cores. The structure is the float32 K5's (attn_bwd.cu), six kernels:
//
// 1. attn_bwd_bf16_wcast_kernel writes seven bfloat16 weight banks in the
//    order the tensor cores read them (chunk of 16 input channels, tap,
//    K-major core matrices): q, k, v as they are, and o, q, k, v with their
//    taps reversed and each tap transposed, W'[j] = W[K-1-j]^T, so the input
//    gradients are ordinary convs (left pad K-1-pad_left).
// 2. attn_bwd_bf16_qkv_conv_kernel: the convs q, k, v (bfloat16 out, the
//    bias added in bfloat16) and dx_attn (float32 out), one per blockIdx.y,
//    on tiles of 16 rows with K4 bf16's conv (tc_bf16_conv.cuh: 192
//    positions, three warpgroups, each chunk of 16 input channels x 3 taps
//    added to a float32 sum on the CUDA cores).
// 3. attn_bwd_bf16_core_kernel: the attention core per row in float32 (a
//    warp per row, lane l owning D/32 features of all 12 steps): x_attn, dq,
//    dk, dv, stored rounded to bfloat16 (each of their consumers rounds
//    them). The core backward uses the float32 p; bf16(p) only feeds x_attn.
// 4. attn_bwd_bf16_dx_conv_kernel: dmq, dmk, dvs (float32), one per
//    blockIdx.y.
// 5. attn_bwd_bf16_dw_kernel: each weight-gradient tap is a [D x R] x
//    [R x D] product over R = rows * 12 (row, t) pairs. One CTA per (split
//    of the rows, tap, weight) walks its rows 8 at a time (96 pairs, 6
//    k-steps of 16): A = bf16(x)^T from registers, read with the tap's time
//    shift from a shared copy of the rows; B = bf16(d(out)), laid out
//    K-major per k-step in shared memory. Chains of 3 k-steps add to a
//    float32 sum on the CUDA cores. It writes its D x D tile as a partial,
//    and the tap-0 CTAs also the bias partial.
// 6. attn_bwd_bf16_sum_kernel sums the partials of the splits in split
//    order.
//
// The TPU kernel adds its weight gradients with += across its sequential
// grid. Here each partial is written once and summed in a fixed order: no
// atomics, the same bits from run to run. Shapes: T = 12, K = 3, dh = 16,
// D = 128 (H = 8) or D = 64 (H = 4), and D3STN's three flag sets (encoder
// self, decoder masked self, decoder source attention).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16_conv.cuh"

namespace {

constexpr int T = tc::T, K = tc::K;
constexpr int PAD_SAME = (K - 1) / 2;
constexpr int CW = 4;          // rows (warps) per CTA of the core kernel
constexpr int DR = 8;          // rows per step of the weight-gradient kernel
constexpr int DP = DR * T;     // its 96 (row, t) pairs
constexpr int DKB = DP / 16;   // its k-steps of 16 pairs
constexpr int GK = 3;          // k-steps per tensor-core chain
using tc16::bank_index;
using tc16::conv;
using tc16::DH;
using tc16::Geo;
using tc16::M;
using tc16::ROWS;
using tc16::THREADS;

// bank i of W'[j][c][f]: i = q, k, v as they are (W_i[j][c][f]), then o, q,
// k, v reversed and transposed (W[K-1-j][f][c]), each rounded to bfloat16
template <int D>
__global__ void attn_bwd_bf16_wcast_kernel(const float* __restrict__ wq,
                                           const float* __restrict__ wk,
                                           const float* __restrict__ wv,
                                           const float* __restrict__ wo,
                                           uint16_t* __restrict__ ws) {
  constexpr int W = Geo<D>::BANK;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 7 * W) return;
  const int i = idx / W;
  const int r = idx - i * W;
  const int j = r / (D * D), c = (r / D) % D, f = r % D;
  float w;
  if (i < 3) {
    w = (i == 0 ? wq : i == 1 ? wk : wv)[r];
  } else {
    const float* src = i == 3 ? wo : i == 4 ? wq : i == 5 ? wk : wv;
    w = src[((K - 1 - j) * D + f) * D + c];
  }
  ws[i * W + bank_index<D>(j, c, f)] = tc16::bits_bf16(w);
}

// ---------------------------------------------------------------------------
// the convs (kernels 2 and 4)
// ---------------------------------------------------------------------------

// up to four convs of one launch, one per blockIdx.y
struct ConvJobs {
  const void* x[4];     // [rows, T, D], float32 (rounded here) or bfloat16
  int x_bf16[4];
  const uint16_t* w[4];  // bfloat16 banks
  const float* b[4];    // the bias: bfloat16 output; nullptr: float32 output, no bias
  void* out[4];
  int padl[4];
};

template <int D>
struct ConvSmem {
  uint16_t x[M][Geo<D>::S];
  uint16_t w[2][Geo<D>::CHUNK];
};

// rows [row0, row0 + ROWS) of src [rows, T, D] -> the bfloat16 tile, zeros
// past n_rows
template <int D>
__device__ __forceinline__ void stage(uint16_t (*xs)[Geo<D>::S], const void* src, bool bf16,
                                      int64_t row0, int n_rows) {
  for (int u = threadIdx.x; u < M * (D / 4); u += THREADS) {
    const int pos = u / (D / 4);
    const int q = u % (D / 4);
    uint2 v = make_uint2(0u, 0u);
    if (pos < n_rows * T) {
      const int64_t off = (row0 * T + pos) * D + 4 * q;
      if (bf16) {
        v = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(src) + off));
      } else {
        const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(src) + off));
        v = make_uint2(tc16::pack_bf16(f.x, f.y), tc16::pack_bf16(f.z, f.w));
      }
    }
    *reinterpret_cast<uint2*>(&xs[pos][4 * q]) = v;
  }
}

template <int D>
__device__ __forceinline__ void conv_rows(const ConvJobs& jobs, int64_t rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ConvSmem<D>& s = *reinterpret_cast<ConvSmem<D>*>(smem_raw);
  const int job = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int n_rows = (int)min((int64_t)ROWS, rows - row0);
  stage<D>(s.x, jobs.x[job], jobs.x_bf16[job] != 0, row0, n_rows);
  __syncthreads();
  float acc[D / 2];
  conv<D>(s.x, jobs.w[job], s.w, jobs.padl[job], acc);
  const float* __restrict__ bias = jobs.b[job];
  const int tq = threadIdx.x & 3;
  const int p0 = tc::frag_row();
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int f = nb * 8 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = p0 + 8 * h;
      if (pos >= n_rows * T) continue;
      const int64_t off = (row0 * T + pos) * D + f;
      const float v0 = acc[4 * nb + 2 * h], v1 = acc[4 * nb + 2 * h + 1];
      if (bias != nullptr) {
        // bf16(bf16(acc) + bf16(bias)), as _tconv_tile
        const float b0 = tc16::round_bf16(__ldg(bias + f));
        const float b1 = tc16::round_bf16(__ldg(bias + f + 1));
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(jobs.out[job]) + off) =
            tc16::pack_bf16(tc16::round_bf16(v0) + b0, tc16::round_bf16(v1) + b1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(jobs.out[job]) + off) = make_float2(v0, v1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_bf16_qkv_conv_kernel(ConvJobs jobs, int64_t rows) {
  conv_rows<D>(jobs, rows);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_bf16_dx_conv_kernel(ConvJobs jobs, int64_t rows) {
  conv_rows<D>(jobs, rows);
}

// ---------------------------------------------------------------------------
// the attention core (kernel 3)
// ---------------------------------------------------------------------------

template <int D>
struct CoreSmem {
  float v[CW][T][D];              // v
  float p[CW][Geo<D>::H][T][T];   // scores, then p (float32)
  float dp[CW][Geo<D>::H][T][T];  // dP, then dS
  float rmax[CW][T];              // each query step's maximum over every head
};

struct CoreArgs {
  const uint16_t *q, *k, *v;
  const float* dxa;
  uint16_t *xatt, *dq, *dk, *dv;
};

template <int N>
__device__ __forceinline__ void ld_bf16(const uint16_t* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = tc16::lo_bf16(a.x); v[1] = tc16::hi_bf16(a.x);
    v[2] = tc16::lo_bf16(a.y); v[3] = tc16::hi_bf16(a.y);
  } else {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    v[0] = tc16::lo_bf16(a); v[1] = tc16::hi_bf16(a);
  }
}

template <int N>
__device__ __forceinline__ void st_bf16(uint16_t* p, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(tc16::pack_bf16(v[0], v[1]), tc16::pack_bf16(v[2], v[3]));
  else
    *reinterpret_cast<uint32_t*>(p) = tc16::pack_bf16(v[0], v[1]);
}

template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}

// sum over the lanes of one head (LPH consecutive lanes)
template <int LPH>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 1; o < LPH; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, bool MASK>
__global__ void __launch_bounds__(CW * 32)
attn_bwd_bf16_core_kernel(CoreArgs io, int64_t rows) {
  constexpr int H = Geo<D>::H;
  constexpr int FPL = D / 32;
  constexpr int LPH = DH / FPL;  // lanes per head
  extern __shared__ __align__(128) unsigned char smem_raw[];
  CoreSmem<D>& s = *reinterpret_cast<CoreSmem<D>*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * CW + warp;
  const bool live = row < rows;
  const int head = lane / LPH;
  const int qd = lane % LPH;
  const float scale = 1.f / sqrtf((float)DH);
  float (*st)[D] = s.v[warp];
  float (*sp)[T][T] = s.p[warp];
  float (*sdp)[T][T] = s.dp[warp];
  float* rmax = s.rmax[warp];

  float q[T][FPL], k[T][FPL], a[T][FPL];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float v[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) q[t][e] = k[t][e] = a[t][e] = v[e] = 0.f;
    if (live) {
      const int64_t off = (row * T + t) * D + lane * FPL;
      ld_bf16(io.q + off, q[t]);
      ld_bf16(io.k + off, k[t]);
      ld_bf16(io.v + off, v);
      ld_f32(io.dxa + off, a[t]);
    }
#pragma unroll
    for (int e = 0; e < FPL; ++e) st[t][lane * FPL + e] = v[e];
  }

  // scores of this lane's head, scaled and masked
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
  // the maximum of a query step over every head's scores (_blockdiag_state)
  if (lane < T) {
    float mx = -INFINITY;
    for (int h = 0; h < H; ++h)
      for (int j = 0; j < T; ++j) mx = fmaxf(mx, sp[h][lane][j]);
    rmax[lane] = mx;
  }
  __syncwarp();
  // p = exp(s - max) / sum over the head, float32 (rows split over the
  // head's lanes)
  for (int r = qd; r < T; r += LPH) {
    float* prow = sp[head][r];
    const float mx = rmax[r];
    float sum = 0.f;
    for (int j = 0; j < T; ++j) {
      prow[j] = expf(prow[j] - mx);
      sum += prow[j];
    }
    for (int j = 0; j < T; ++j) prow[j] = prow[j] / sum;
  }
  __syncwarp();

  // x_attn = bf16(bf16(P) V) (the out conv's input, for its weight gradient)
  if (live) {
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      float o[FPL];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
      for (int tk = 0; tk < T; ++tk) {
        const float pw = tc16::round_bf16(sp[head][tq][tk]);
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, st[tk][lane * FPL + e], o[e]);
      }
      st_bf16(io.xatt + (row * T + tq) * D + lane * FPL, o);
    }
  }

  // dP = dx_attn V^T per head
#pragma unroll
  for (int tk = 0; tk < T; ++tk) {
    float vv[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) vv[e] = st[tk][lane * FPL + e];
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < FPL; ++e) d = fmaf(a[tq][e], vv[e], d);
      d = head_sum<LPH>(d);
      if (qd == 0) sdp[head][tq][tk] = d;
    }
  }
  // dV = P^T dx_attn, with the float32 P
  if (live) {
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
      st_bf16(io.dv + (row * T + tk) * D + lane * FPL, o);
    }
  }
  __syncwarp();
  // dS = P (.) (dP - rowsum(dP P)) / sqrt(dh), in place of dP
  for (int r = qd; r < T; r += LPH) {
    float* drow = sdp[head][r];
    const float* prow = sp[head][r];
    float dot = 0.f;
    for (int j = 0; j < T; ++j) dot = fmaf(drow[j], prow[j], dot);
    for (int j = 0; j < T; ++j) drow[j] = prow[j] * (drow[j] - dot) * scale;
  }
  __syncwarp();
  if (!live) return;

  // dQ = dS K, dK = dS^T Q
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
    st_bf16(io.dq + (row * T + tq) * D + lane * FPL, o);
  }
#pragma unroll
  for (int tk = 0; tk < T; ++tk) {
    float o[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      const float dsv = sdp[head][tq][tk];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = fmaf(dsv, q[tq][e], o[e]);
    }
    st_bf16(io.dk + (row * T + tk) * D + lane * FPL, o);
  }
}

// ---------------------------------------------------------------------------
// the weight gradients (kernels 5 and 6)
// ---------------------------------------------------------------------------

struct DwArgs {
  const void* x[4];  // conv inputs: mq, mk, vs (float32, rounded here), x_attn (bfloat16)
  int x_bf16[4];
  const uint16_t* g[4];  // their output gradients, bfloat16: dq, dk, dv, g
  int padl[4];
};

template <int D>
struct DwSmem {
  uint16_t x[DP][D + 8];  // bf16(x) of the step's rows, as they are
  uint16_t b[DKB][D * 16];  // bf16(d(out)) per k-step of 16 pairs, K-major (tc16::b_offset)
};

// rows [r0, r0 + n) of x -> s.x and of g -> s.b (zeros past n)
template <int D>
__device__ __forceinline__ void dw_load(DwSmem<D>& s, const void* X, bool x_bf16,
                                        const uint16_t* __restrict__ Gr, int64_t r0, int n) {
  for (int u = threadIdx.x; u < DP * (D / 4); u += blockDim.x) {
    const int p = u / (D / 4);
    const int c = 4 * (u % (D / 4));
    uint2 v = make_uint2(0u, 0u);
    if (p < n * T) {
      const int64_t off = (r0 * T + p) * D + c;
      if (x_bf16) {
        v = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(X) + off));
      } else {
        const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(X) + off));
        v = make_uint2(tc16::pack_bf16(f.x, f.y), tc16::pack_bf16(f.z, f.w));
      }
    }
    *reinterpret_cast<uint2*>(&s.x[p][c]) = v;
  }
  // 8 outputs of one pair a thread, consecutive threads on consecutive pairs
  for (int u = threadIdx.x; u < DP * (D / 8); u += blockDim.x) {
    const int p = u % DP;
    const int f = 8 * (u / DP);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < n * T) v = __ldg(reinterpret_cast<const uint4*>(Gr + (r0 * T + p) * D + f));
    uint16_t* dst = &s.b[p / 16][tc16::b_offset(f, p % 16)];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[16 * i] = (uint16_t)(w[i] & 0xFFFFu);   // output f + 2 i: 8 elements further per output
      dst[16 * i + 8] = (uint16_t)(w[i] >> 16);
    }
  }
}

// part[split][(i K + j) D D + c D + f] = sum over the split's rows and steps
// t of bf16(xpad_i)[t + j][c] bf16(g_i)[t][f]; the tap-0 CTAs also write
// part[split][4 K D D + i D + f] = sum of bf16(g_i)[t][f]. blockIdx.x =
// split K + tap, blockIdx.y = i. D / 64 warpgroups: warpgroup w owns the
// channels 64 w .. 64 w + 63 (wgmma m64nDk16, M = channels, N = outputs,
// K = pairs).
template <int D>
__global__ void __launch_bounds__(2 * D, 1)
attn_bwd_bf16_dw_kernel(DwArgs args, int64_t rows, int64_t rows_per_split, float* __restrict__ part) {
  constexpr int64_t L = 4 * (int64_t)K * D * D + 4 * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DwSmem<D>& s = *reinterpret_cast<DwSmem<D>*>(smem_raw);
  const int tap = blockIdx.x % K;
  const int64_t split = blockIdx.x / K;
  const int wi = blockIdx.y;
  const void* X = args.x[wi];
  const bool x_bf16 = args.x_bf16[wi] != 0;
  const uint16_t* __restrict__ Gr = args.g[wi];
  const int shift = tap - args.padl[wi];
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min(rows, r_begin + rows_per_split);
  const int tq = threadIdx.x & 3;
  const int c0 = tc::frag_row();  // the thread's channels: c0 and c0 + 8
  const bool bias_thread = tap == 0 && threadIdx.x < D;

  float acc[D / 2], chain[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = chain[i] = 0.f;
  float bsum = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += DR) {
    const int n = (int)min((int64_t)DR, r_end - r0);
    const int np = n * T;
    __syncthreads();  // the previous step's reads are done
    dw_load<D>(s, X, x_bf16, Gr, r0, n);
    tc::fence_proxy_async();
    __syncthreads();
    if (bias_thread) {
      for (int p = 0; p < np; ++p) bsum += tc16::from_bf16(s.b[p / 16][tc16::b_offset(threadIdx.x, p % 16)]);
    }
    const int kbs = (np + 15) / 16;
    for (int kb0 = 0; kb0 < kbs; kb0 += GK) {
      // A = bf16(x)^T: register 0 (channel c0, pairs 2 tq, 2 tq + 1), 1 (c0 + 8,
      // the same), 2 (c0, 8 + 2 tq ..), 3 (c0 + 8, 8 + ...) of each k-step,
      // x read with the tap's shift
      uint32_t af[GK][4];
#pragma unroll
      for (int i = 0; i < GK; ++i)
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          uint16_t v[2][2];  // [channel c0, c0 + 8][pair, pair + 1]
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = (kb0 + i) * 16 + 8 * hk + 2 * tq + e;
            const int ts = p % T + shift;
            const bool ok = p < np && ts >= 0 && ts < T;
            const uint16_t* xr = &s.x[ok ? p + shift : 0][c0];
            v[0][e] = ok ? xr[0] : (uint16_t)0;
            v[1][e] = ok ? xr[8] : (uint16_t)0;
          }
          af[i][2 * hk] = (uint32_t)v[0][0] | ((uint32_t)v[0][1] << 16);
          af[i][2 * hk + 1] = (uint32_t)v[1][0] | ((uint32_t)v[1][1] << 16);
        }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) tc::hold(chain[i]);
      tc::wgmma_fence();
#pragma unroll
      for (int i = 0; i < GK; ++i) {
        if (kb0 + i < kbs)
          tc16::wgmma<D>(chain, af[i], tc::desc_b(reinterpret_cast<const float*>(&s.b[kb0 + i][0])),
                         i > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < GK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::hold(af[i][e]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        tc::hold(chain[i]);
        acc[i] += chain[i];
      }
    }
  }

  float* out = part + split * L + (int64_t)(wi * K + tap) * D * D;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int f = nb * 8 + 2 * tq;
    *reinterpret_cast<float2*>(out + (int64_t)c0 * D + f) = make_float2(acc[4 * nb], acc[4 * nb + 1]);
    *reinterpret_cast<float2*>(out + (int64_t)(c0 + 8) * D + f) =
        make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
  }
  if (bias_thread) part[split * L + 4 * (int64_t)K * D * D + wi * D + threadIdx.x] = bsum;
}

// out[i] = sum over the splits, in split order, of part[split][i]
__global__ void attn_bwd_bf16_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                         int64_t len, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * len + i];
  out[i] = s;
}

// scratch, in bytes: seven bfloat16 banks; q, k, v (bfloat16); dx_attn
// (float32); x_attn, dq, dk, dv (bfloat16); the float32 partials
template <int D>
int64_t scratch_bytes(int64_t rows, int splits) {
  const int64_t act = rows * T * D;
  return 2 * 7 * (int64_t)Geo<D>::BANK + 2 * 7 * act + 4 * act +
         4 * (int64_t)splits * (4 * (int64_t)K * D * D + 4 * D);
}

template <int D>
int launch(const void* const* p, void* const* out, unsigned char* scratch, int64_t rows,
           int splits, int causal_q, int causal_kv, cudaStream_t stream) {
  constexpr int64_t BANK = Geo<D>::BANK;
  const int64_t act = rows * T * D;
  uint16_t* ws = reinterpret_cast<uint16_t*>(scratch);
  uint16_t* q = ws + 7 * BANK;
  uint16_t* k = q + act;
  uint16_t* v = k + act;
  uint16_t* xatt = v + act;
  uint16_t* dq = xatt + act;
  uint16_t* dk = dq + act;
  uint16_t* dv = dk + act;
  float* dxa = reinterpret_cast<float*>(dv + act);
  float* part = dxa + act;
  const float* mq = (const float*)p[0];
  const float* mk = (const float*)p[1];
  const float* vs = (const float*)p[2];
  const uint16_t* g = (const uint16_t*)p[11];
  const int pq = causal_q ? K - 1 : PAD_SAME;
  const int pkv = causal_kv ? K - 1 : PAD_SAME;

  attn_bwd_bf16_wcast_kernel<D><<<(unsigned)((7 * BANK + 255) / 256), 256, 0, stream>>>(
      (const float*)p[3], (const float*)p[5], (const float*)p[7], (const float*)p[9], ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int conv_smem = (int)sizeof(ConvSmem<D>);
  const unsigned tiles = (unsigned)((rows + ROWS - 1) / ROWS);
  ConvJobs fwd = {{mq, mk, vs, g},
                  {0, 0, 0, 1},
                  {ws, ws + BANK, ws + 2 * BANK, ws + 3 * BANK},
                  {(const float*)p[4], (const float*)p[6], (const float*)p[8], nullptr},
                  {q, k, v, dxa},
                  {pq, pkv, pkv, K - 1 - PAD_SAME}};
  err = cudaFuncSetAttribute(attn_bwd_bf16_qkv_conv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_qkv_conv_kernel<D><<<dim3(tiles, 4), THREADS, conv_smem, stream>>>(fwd, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int core_smem = (int)sizeof(CoreSmem<D>);
  const unsigned core_blocks = (unsigned)((rows + CW - 1) / CW);
  CoreArgs io = {q, k, v, dxa, xatt, dq, dk, dv};
  if (causal_q && causal_kv) {
    err = cudaFuncSetAttribute(attn_bwd_bf16_core_kernel<D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, core_smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_bf16_core_kernel<D, true><<<core_blocks, CW * 32, core_smem, stream>>>(io, rows);
  } else {
    err = cudaFuncSetAttribute(attn_bwd_bf16_core_kernel<D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, core_smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_bf16_core_kernel<D, false><<<core_blocks, CW * 32, core_smem, stream>>>(io, rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ConvJobs bwd = {{dq, dk, dv, nullptr},
                  {1, 1, 1, 1},
                  {ws + 4 * BANK, ws + 5 * BANK, ws + 6 * BANK, nullptr},
                  {nullptr, nullptr, nullptr, nullptr},
                  {out[0], out[1], out[2], nullptr},
                  {K - 1 - pq, K - 1 - pkv, K - 1 - pkv, 0}};
  err = cudaFuncSetAttribute(attn_bwd_bf16_dx_conv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_dx_conv_kernel<D><<<dim3(tiles, 3), THREADS, conv_smem, stream>>>(bwd, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwArgs args = {{mq, mk, vs, xatt}, {0, 0, 0, 1}, {dq, dk, dv, g}, {pq, pkv, pkv, PAD_SAME}};
  const int dw_smem = (int)sizeof(DwSmem<D>);
  const int64_t rows_per_split = (rows + splits - 1) / splits;
  err = cudaFuncSetAttribute(attn_bwd_bf16_dw_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_dw_kernel<D><<<dim3(K * splits, 4), 2 * D, dw_smem, stream>>>(
      args, rows, rows_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t len = 4 * (int64_t)K * D * D + 4 * D;
  attn_bwd_bf16_sum_kernel<<<(unsigned)((len + 255) / 256), 256, 0, stream>>>(
      part, (float*)out[3], len, splits);
  return (int)cudaGetLastError();
}

bool flags_ok(int causal_q, int causal_kv, int is_mask) {
  return (!causal_q && !causal_kv && !is_mask) || (causal_q && causal_kv && is_mask) ||
         (causal_q && !causal_kv && !is_mask);
}

}  // namespace

extern "C" int64_t pxt_attn_bwd_bf16_scratch_bytes(int64_t rows, int splits, int d) {
  if (d == 128) return scratch_bytes<128>(rows, splits);
  if (d == 64) return scratch_bytes<64>(rows, splits);
  return -1;
}

// p: the 12 inputs mq, mk, vs (float32 [rows, 12, d]), wq, bq, wk, bk, wv,
// bv, wo, bo (float32), g (bfloat16 [rows, 12, d]); out: dmq, dmk, dvs
// (float32) and one float32 buffer of 4 K d d + 4 d: dWq, dWk, dWv, dWo, then
// dbq, dbk, dbv, dbo; scratch: pxt_attn_bwd_bf16_scratch_bytes (16-byte
// aligned); d = 64 or 128 with head dim 16
extern "C" int pxt_attn_bwd_bf16(const void* const* p, void* const* out, void* scratch,
                                 int64_t rows, int splits, int d, int causal_q, int causal_kv,
                                 int is_mask, void* stream) {
  if (rows <= 0 || splits <= 0 || !flags_ok(causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = (unsigned char*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch<128>(p, out, sc, rows, splits, causal_q, causal_kv, s);
  if (d == 64) return launch<64>(p, out, sc, rows, splits, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
