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
// Bound: operations. Eleven conv-sized products per row (2 K D^2 T flops
// each) are 98% of the work; they run on the tensor cores in 3xTF32
// (float32 accuracy; tc_conv.cuh), the attention core on the CUDA cores. Six
// kernels per call:
//
// 1. attn_bwd_wt_kernel writes seven split weight banks ({big, small} TF32
//    halves in tc::bank_index order): q, k, v as they are, and o, q, k, v with
//    their taps reversed and each tap transposed, W'[j] = W[K-1-j]^T, so the
//    input gradients are ordinary convs (left pad K-1-pad_left).
// 2. attn_bwd_qkv_conv_kernel: the convs q, k, v (recomputed) and dx_attn,
//    one per blockIdx.y, on tiles of 16 rows (tc::conv, three warpgroups,
//    wgmma m64nDk8; 147 KB of shared memory at D = 128).
// 3. attn_bwd_core_kernel: the attention core per row (a warp per row, lane
//    l owning D/32 features of all 12 steps; P and dP/dS in per-warp shared
//    tiles): x_attn, dq, dk, dv.
// 4. attn_bwd_dx_conv_kernel: dmq, dmk, dvs, one per blockIdx.y.
// 5. attn_bwd_dw_kernel: each weight gradient tap is a [D x R] x [R x D]
//    product over R = rows * 12 (row, t) pairs. One CTA per (split of the
//    rows, tap, weight) walks its rows 4 at a time (48 pairs, 6 k-blocks of
//    8) with wgmma m64nDk8: A = x^T from registers, read with the tap's time
//    shift from a shared copy of x; B = d(out), split and laid out K-major
//    per k-block in shared memory. A step's 18 products (6 k-blocks x 3
//    terms) sum on the tensor cores and then add to a float32 sum on the
//    CUDA cores (tc_conv.cuh). While the tensor cores run, the next step's x
//    and d(out) are copied in (cp.async) and d(out) is split into the other
//    buffer. It writes its
//    D x D tile as a partial, and the tap-0 CTAs also the bias partial.
//    Consecutive CTAs share a split, so the three taps read the same rows
//    while they are in L2.
// 6. attn_bwd_sum_kernel sums the partials of the splits in split order.
//
// Why not one row kernel: a row's q, k, v, dx_attn, P and dP with the
// weight stages do not fit 227 KB of shared memory at a tile of 8 rows, and
// smaller tiles re-read the weight banks from L2 once per tile and conv.
// q, k, v and dx_attn go through device memory instead (4 x 2 x 33 MB at
// PEMS08, batch 32), as do x_attn, dq, dk and dv for the weight gradients.
//
// Dropout form (the TPU _bwd_kernel with has_dropout=True, the backward of
// fused_temporal_attention_dropout; entry pxt_attn_bwd_f32_dropout): the
// keep mask m [rows, T, H*T] (float32, pre-scaled {0, 1/keep}, head-major)
// enters only the core, the DROP instantiation of attn_bwd_core_kernel,
// which stages each row's m in shared memory: x_attn = (p m) v, dv_h =
// (p m)^T dx_attn_h, dp = (dx_attn_h v_h^T) m, and ds from the pre-dropout
// p. The convs and the weight gradients are the same kernels.
//
// The TPU kernel zeroes the weight gradients at program (0, 0) and adds to
// them with += across its sequential grid. Here each partial is written
// once and summed in a fixed order: no atomics, the same bits from run to
// run. Shapes: T = 12, K = 3, dh = 16, D = 128 (H = 8) or D = 64 (H = 4),
// and D3STN's three flag sets (encoder self, decoder masked self, decoder
// source attention).

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_conv.cuh"

namespace {

constexpr int T = tc::T, K = tc::K, DH = 16;
constexpr int CW = 4;   // rows (warps) per CTA of the core kernel
constexpr int CR = 16;  // rows per CTA of the conv kernels: 192 positions, 3 warpgroups
constexpr int DR = 4;            // rows per staging step of the weight-gradient kernel
constexpr int DKB = DR * T / 8;  // its k-blocks of 8 (row, t) pairs
constexpr int GKB = 6;           // k-blocks per tensor-core chain (18 products): one a step
constexpr int PAD_SAME = (K - 1) / 2;

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

// split bank i of W'[j][c][f] (tc::bank_index order): i = q, k, v as they
// are (W_i[j][c][f]), then o, q, k, v reversed and transposed (W[K-1-j][f][c])
template <int D>
__global__ void attn_bwd_wt_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                                   const float* __restrict__ wv, const float* __restrict__ wo,
                                   float* __restrict__ wt) {
  constexpr int W = K * D * D;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 7 * (int64_t)W) return;
  const int i = (int)(idx / W);
  const int r = (int)(idx - (int64_t)i * W);
  const int j = r / (D * D), c = (r / D) % D, f = r % D;
  float w;
  if (i < 3) {
    w = (i == 0 ? wq : i == 1 ? wk : wv)[r];
  } else {
    const float* src = i == 3 ? wo : i == 4 ? wq : i == 5 ? wk : wv;
    w = src[((K - 1 - j) * D + f) * D + c];
  }
  tc::put_split<D>(wt + (int64_t)i * tc::Bank<D>::SIZE, j, c, f, w);
}

// up to four convs of one launch, one per blockIdx.y
struct ConvJobs {
  const float* x[4];
  const float* w[4];   // split banks
  const float* b[4];  // nullable
  float* out[4];
  int padl[4];
};

template <int D>
__device__ __forceinline__ void conv_rows(const ConvJobs& jobs, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ws = xs + tc::Geo<D, CR>::TILE;
  const int job = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * CR;
  const int n_rows = (int)min((int64_t)CR, rows - row0);
  tc::stage<D, CR>(xs, jobs.x[job], row0, n_rows);
  __syncthreads();
  tc::Acc<D> acc;
  tc::conv<D, CR>(xs, jobs.w[job], ws, jobs.padl[job], acc);
  tc::store_global<D, CR>(jobs.out[job], row0, n_rows, acc, jobs.b[job]);
}

template <int D>
__global__ void __launch_bounds__(tc::Geo<D, CR>::THREADS, 1)
attn_bwd_qkv_conv_kernel(ConvJobs jobs, int64_t rows) {
  conv_rows<D>(jobs, rows);
}

template <int D>
__global__ void __launch_bounds__(tc::Geo<D, CR>::THREADS, 1)
attn_bwd_dx_conv_kernel(ConvJobs jobs, int64_t rows) {
  conv_rows<D>(jobs, rows);
}

template <int D>
struct CoreSmem {
  static constexpr int H = D / DH;
  float v[CW][T][D];         // v
  float p[CW][H][T][T];      // softmax
  float dp[CW][H][T][T];     // dP, then dS
};

struct CoreArgs {
  const float *q, *k, *v, *dxa;
  float *xatt, *dq, *dk, *dv;
};

// sum over the lanes of one head (LPH consecutive lanes)
template <int LPH>
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = 1; o < LPH; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the keep masks of the core's rows with DROP, after CoreSmem: [CW][H][T][T]
template <int D, bool DROP>
constexpr int core_smem_bytes() {
  return (int)sizeof(CoreSmem<D>) + (DROP ? CW * (D / DH) * T * T * (int)sizeof(float) : 0);
}

template <int D, bool MASK, bool DROP>
__global__ void __launch_bounds__(CW * 32)
attn_bwd_core_kernel(CoreArgs io, const float* __restrict__ dm, int64_t rows) {
  constexpr int FPL = D / 32;
  constexpr int LPH = DH / FPL;  // lanes per head
  constexpr int H = D / DH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  // the row's keep mask as [head][query step][key step]
  float (*smk)[T][T] =
      reinterpret_cast<float (*)[T][T]>(smem_raw + sizeof(CoreSmem<D>)) + warp * H;
  if (DROP) {
    for (int u = lane; u < T * H * T; u += 32)
      smk[(u / T) % H][u / (H * T)][u % T] = live ? __ldg(dm + row * (T * H * T) + u) : 0.f;
  }

  float q[T][FPL], k[T][FPL], a[T][FPL];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float v[FPL];
#pragma unroll
    for (int e = 0; e < FPL; ++e) q[t][e] = k[t][e] = a[t][e] = v[e] = 0.f;
    if (live) {
      const int64_t off = (row * T + t) * D + lane * FPL;
      ldv(io.q + off, q[t]);
      ldv(io.k + off, k[t]);
      ldv(io.dxa + off, a[t]);
      ldv(io.v + off, v);
    }
    stv(&st[t][lane * FPL], v);
  }

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

  // x_attn = P V (the out conv's input, for its weight gradient); with
  // DROP (P m) V
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
        const float pw = DROP ? sp[head][tq][tk] * smk[head][tq][tk] : sp[head][tq][tk];
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, vv[e], o[e]);
      }
      stv(io.xatt + (row * T + tq) * D + lane * FPL, o);
    }
  }

  // dP = dx_attn V^T per head; with DROP dP m
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
      if (qd == 0) sdp[head][tq][tk] = DROP ? d * smk[head][tq][tk] : d;
    }
  }
  // dV = P^T dx_attn; with DROP (P m)^T dx_attn
  if (live) {
#pragma unroll
    for (int tk = 0; tk < T; ++tk) {
      float o[FPL];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
      for (int tq = 0; tq < T; ++tq) {
        const float pw = DROP ? sp[head][tq][tk] * smk[head][tq][tk] : sp[head][tq][tk];
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, a[tq][e], o[e]);
      }
      stv(io.dv + (row * T + tk) * D + lane * FPL, o);
    }
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
  if (!live) return;

  // dQ = dS K / sqrt(dh), dK = dS^T Q / sqrt(dh)
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
    stv(io.dq + (row * T + tq) * D + lane * FPL, o);
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
#pragma unroll
    for (int e = 0; e < FPL; ++e) o[e] *= scale;
    stv(io.dk + (row * T + tk) * D + lane * FPL, o);
  }
}

struct DwArgs {
  const float* x[4];  // conv inputs: mq, mk, vs, x_attn
  const float* g[4];  // their output gradients: dq, dk, dv, g
  int padl[4];
};

template <int D>
struct DwSmem {
  float x[2][DR * T][D + 4];  // conv inputs, as they are; two steps
  float b[2][DKB][2][D * 8];  // output gradients per k-block of 8 pairs: big, small
  float graw[DR * T][D + 8];  // the next step's output gradients as they are
};

// the raw output gradients of a step -> buffer buf, split and laid out
// K-major per k-block (tc::b_offset). A warp takes 8 outputs x 4 pairs at a
// time (lane = 8 pair + output): with graw's row stride D + 8 the loads, and
// with b_offset's 16-byte rows the stores, touch 32 distinct banks.
template <int D>
__device__ __forceinline__ void dw_split(DwSmem<D>& s, int buf) {
  for (int u = threadIdx.x; u < DR * T * D; u += blockDim.x) {
    const int f = (u / 32) % (D / 8) * 8 + u % 8;
    const int p = (u / (4 * D)) * 4 + (u / 8) % 4;
    uint32_t big, small;
    tc::split_tf32(s.graw[p][f], big, small);
    const int off = tc::b_offset(f, p % 8);
    s.b[buf][p / 8][0][off] = __uint_as_float(big);
    s.b[buf][p / 8][1][off] = __uint_as_float(small);
  }
}

// rows [r0, r0 + n) of x -> s.x[buf] and of g -> s.graw (cp.async, zeros
// past n; committed, not waited for)
template <int D>
__device__ __forceinline__ void dw_load(DwSmem<D>& s, int buf, const float* __restrict__ X,
                                        const float* __restrict__ Gr, int64_t r0, int n) {
  const float* gb = Gr + r0 * T * D;
  for (int u = threadIdx.x; u < DR * T * (D / 4); u += blockDim.x) {
    const int p = u / (D / 4);
    const int q = u % (D / 4);
    const bool full = p < n * T;
    tc::cp_async16_zfill(&s.graw[p][4 * q], gb + (full ? p * D + 4 * q : 0), full);
  }
  tc::stage_async<D, DR>(&s.x[buf][0][0], X, r0, n);
}

// part[split][(i K + j) D D + c D + f] = sum over the split's rows and steps
// t of xpad_i[t + j][c] g_i[t][f]; the tap-0 CTAs also write
// part[split][4 K D D + i D + f] = sum of g_i[t][f]. blockIdx.x = split K +
// tap, blockIdx.y = i. D / 64 warpgroups: warpgroup w owns the channels
// 64 w .. 64 w + 63 (wgmma m64nDk8, M = channels, N = outputs, K = pairs).
// While the tensor cores run a step's chain, the next step's x and g are
// copied in (cp.async) and g is split into the other buffer.
template <int D>
__global__ void __launch_bounds__(2 * D, 1)
attn_bwd_dw_kernel(DwArgs args, int64_t rows, int64_t rows_per_split, float* __restrict__ part) {
  constexpr int64_t L = 4 * (int64_t)K * D * D + 4 * D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<D>& s = *reinterpret_cast<DwSmem<D>*>(smem_raw);
  const int tap = blockIdx.x % K;
  const int64_t split = blockIdx.x / K;
  const int wi = blockIdx.y;
  const float* __restrict__ X = args.x[wi];
  const float* __restrict__ Gr = args.g[wi];
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

  if (r_begin < r_end) {
    dw_load<D>(s, 0, X, Gr, r_begin, (int)min((int64_t)DR, r_end - r_begin));
    tc::cp_async_wait_all();
    __syncthreads();
    dw_split<D>(s, 0);
  }
  tc::fence_proxy_async();
  __syncthreads();
  int buf = 0;
  for (int64_t r0 = r_begin; r0 < r_end; r0 += DR, buf ^= 1) {
    const int np = (int)min((int64_t)DR, r_end - r0) * T;
    const int kbs = (np + 7) / 8;
    const int64_t r1 = r0 + DR;
    for (int kb0 = 0; kb0 < kbs; kb0 += GKB) {
      // A = x^T: a0 (channel c0, pair tq), a1 (c0 + 8, tq), a2 (c0, tq + 4),
      // a3 (c0 + 8, tq + 4) of each k-block, x read with the tap's shift
      uint32_t ab[GKB][4], as[GKB][4];
#pragma unroll
      for (int i = 0; i < GKB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (kb0 + i) * 8 + tq + 4 * h;
          const int ts = p % T + shift;
          const bool ok = p < np && ts >= 0 && ts < T;
          const float* xr = &s.x[buf][ok ? p + shift : 0][c0];
          tc::split_tf32(ok ? xr[0] : 0.f, ab[i][2 * h], as[i][2 * h]);
          tc::split_tf32(ok ? xr[8] : 0.f, ab[i][2 * h + 1], as[i][2 * h + 1]);
        }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) tc::hold(chain[i]);
      tc::wgmma_fence();
#pragma unroll
      for (int i = 0; i < GKB; ++i) {
        if (kb0 + i < kbs) {
          const uint64_t big = tc::desc_b(&s.b[buf][kb0 + i][0][0]);
          const uint64_t small = tc::desc_b(&s.b[buf][kb0 + i][1][0]);
          tc::wgmma<D>(chain, as[i], big, i > 0);
          tc::wgmma<D>(chain, ab[i], small, 1);
          tc::wgmma<D>(chain, ab[i], big, 1);
        }
      }
      tc::wgmma_commit();
      // while the tensor cores run: the bias sum in pair order (big + small
      // is g exactly), the next step's copy and its split
      if (kb0 == 0) {
        if (bias_thread) {
#pragma unroll 4
          for (int p = 0; p < np; ++p) {
            const int off = tc::b_offset(threadIdx.x, p % 8);
            bsum += s.b[buf][p / 8][0][off] + s.b[buf][p / 8][1][off];
          }
        }
        if (r1 < r_end) dw_load<D>(s, buf ^ 1, X, Gr, r1, (int)min((int64_t)DR, r_end - r1));
      }
      if (kb0 + GKB >= kbs && r1 < r_end) {
        tc::cp_async_wait_all();
        __syncthreads();
        dw_split<D>(s, buf ^ 1);
      }
      tc::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < GKB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tc::hold(ab[i][e]);
          tc::hold(as[i][e]);
        }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        tc::hold(chain[i]);
        acc[i] += chain[i];
      }
    }
    tc::fence_proxy_async();
    __syncthreads();
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
  return 14 * (int64_t)K * D * D + 8 * rows * T * D + splits * (4 * (int64_t)K * D * D + 4 * D);
}

template <int D, bool MASK, bool DROP>
int launch_core(const CoreArgs& io, const float* dm, int64_t rows, cudaStream_t stream) {
  constexpr int smem = core_smem_bytes<D, DROP>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_core_kernel<D, MASK, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_core_kernel<D, MASK, DROP><<<(unsigned)((rows + CW - 1) / CW), CW * 32, smem,
                                        stream>>>(io, dm, rows);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch(const void* const* p, const float* dm, void* const* out, float* scratch,
           int64_t rows, int splits, int causal_q, int causal_kv, cudaStream_t stream) {
  constexpr int64_t BANK = tc::Bank<D>::SIZE;  // 2 K D^2 floats
  constexpr int64_t W = (int64_t)K * D * D;
  const int64_t act = rows * T * D;
  float* wt = scratch;
  float* q = scratch + 7 * BANK;  // q, k, v, dx_attn, x_attn, dq, dk, dv: [rows, T, D] each
  float* k = q + act;
  float* v = k + act;
  float* dxa = v + act;
  float* xatt = dxa + act;
  float* dq = xatt + act;
  float* dk = dq + act;
  float* dv = dk + act;
  float* part = dv + act;
  const float* mq = (const float*)p[0];
  const float* mk = (const float*)p[1];
  const float* vs = (const float*)p[2];
  const float* g = (const float*)p[11];
  const int pq = causal_q ? K - 1 : PAD_SAME;
  const int pkv = causal_kv ? K - 1 : PAD_SAME;

  attn_bwd_wt_kernel<D><<<(unsigned)((7 * W + 255) / 256), 256, 0, stream>>>(
      (const float*)p[3], (const float*)p[5], (const float*)p[7], (const float*)p[9], wt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int conv_threads = tc::Geo<D, CR>::THREADS;
  const int conv_smem = (tc::Geo<D, CR>::TILE + tc::Bank<D>::STAGES) * 4;
  const unsigned tiles = (unsigned)((rows + CR - 1) / CR);
  ConvJobs fwd = {{mq, mk, vs, g},
                  {wt, wt + BANK, wt + 2 * BANK, wt + 3 * BANK},
                  {(const float*)p[4], (const float*)p[6], (const float*)p[8], nullptr},
                  {q, k, v, dxa},
                  {pq, pkv, pkv, K - 1 - PAD_SAME}};
  err = cudaFuncSetAttribute(attn_bwd_qkv_conv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_qkv_conv_kernel<D><<<dim3(tiles, 4), conv_threads, conv_smem, stream>>>(fwd, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CoreArgs io = {q, k, v, dxa, xatt, dq, dk, dv};
  const int core_err = causal_q && causal_kv ? launch_core<D, true, DROP>(io, dm, rows, stream)
                                             : launch_core<D, false, DROP>(io, dm, rows, stream);
  if (core_err != 0) return core_err;

  ConvJobs bwd = {{dq, dk, dv, nullptr},
                  {wt + 4 * BANK, wt + 5 * BANK, wt + 6 * BANK, nullptr},
                  {nullptr, nullptr, nullptr, nullptr},
                  {(float*)out[0], (float*)out[1], (float*)out[2], nullptr},
                  {K - 1 - pq, K - 1 - pkv, K - 1 - pkv, 0}};
  err = cudaFuncSetAttribute(attn_bwd_dx_conv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dx_conv_kernel<D><<<dim3(tiles, 3), conv_threads, conv_smem, stream>>>(bwd, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwArgs args = {{mq, mk, vs, xatt}, {dq, dk, dv, g}, {pq, pkv, pkv, PAD_SAME}};
  const int dw_smem = (int)sizeof(DwSmem<D>);
  const int64_t rows_per_split = (rows + splits - 1) / splits;
  err = cudaFuncSetAttribute(attn_bwd_dw_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dw_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dw_kernel<D><<<dim3(K * splits, 4), 2 * D, dw_smem, stream>>>(
      args, rows, rows_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t len = 4 * W + 4 * D;
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
  float* sc = (float*)scratch;
  if (d == 128) return launch<128, false>(p, nullptr, out, sc, rows, splits, causal_q, causal_kv, s);
  if (d == 64) return launch<64, false>(p, nullptr, out, sc, rows, splits, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

// the dropout form; dmask: float32 [rows, 12, (d / 16) * 12]
extern "C" int pxt_attn_bwd_f32_dropout(const void* const* p, const void* dmask,
                                        void* const* out, void* scratch, int64_t rows,
                                        int splits, int d, int causal_q, int causal_kv,
                                        int is_mask, void* stream) {
  if (rows <= 0 || splits <= 0 || !flags_ok(causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* sc = (float*)scratch;
  const float* dm = (const float*)dmask;
  if (d == 128) return launch<128, true>(p, dm, out, sc, rows, splits, causal_q, causal_kv, s);
  if (d == 64) return launch<64, true>(p, dm, out, sc, rows, splits, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
