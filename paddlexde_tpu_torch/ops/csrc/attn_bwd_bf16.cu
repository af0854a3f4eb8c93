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
// (the convs wgmma m64nDk16 in the RS form, tc_bf16.cuh; the weight
// gradients m64n(D/2)k16 from shared memory, kernel 5), the attention core
// on the CUDA cores. The structure is the float32 K5's (attn_bwd.cu), six
// launches of five kernels:
//
// 1. attn_bwd_bf16_wcast_kernel writes seven bfloat16 weight banks in the
//    order the tensor cores read them (chunk of 16 input channels, tap,
//    K-major core matrices): q, k, v as they are, and o, q, k, v with their
//    taps reversed and each tap transposed, W'[j] = W[K-1-j]^T, so the input
//    gradients are ordinary convs (left pad K-1-pad_left).
// 2. attn_bwd_bf16_conv_kernel with four jobs: the convs q, k, v (bfloat16
//    out, the bias added in bfloat16) and dx_attn (float32 out).
// 3. attn_bwd_bf16_core_kernel: the attention core per row in float32 (a
//    warp per row, lane l owning D/32 features of all 12 steps): x_attn, dq,
//    dk, dv, stored rounded to bfloat16 (each of their consumers rounds
//    them). The core backward uses the float32 p; bf16(p) only feeds x_attn.
// 4. attn_bwd_bf16_conv_kernel again with three jobs: dmq, dmk, dvs
//    (float32 out).
//    The conv stage (2 and 4) is bound by bytes: at PEMS08, batch 32, it
//    reads mq, mk, vs (float32), g, dq, dk, dv (bfloat16) and writes q, k, v
//    (bfloat16), dx_attn, dmq, dmk, dvs (float32), 351 MB, 0.105 ms at 3.35
//    TB/s, against 0.045 ms of products. The kernel is persistent and
//    warp-specialised (tc_bf16_conv.cuh has the chain and its numerics):
//    - one CTA per SM, on one job (the SMs shared out over the jobs,
//      ops/attn.py::bf16_conv_ctas), walking that job's tiles of 16 rows
//      (192 positions) with a stride of the job's CTA count;
//    - the job's whole bank (98,304 bytes at D = 128) stays in shared
//      memory, loaded once by bulk copies (before: every 16 rows streamed it
//      from L2 in chunks, behind two CTA barriers a chunk);
//    - a producer warpgroup fills a ring of bfloat16 x tiles (2 x 52,224
//      bytes at D = 128, 4 x 27,648 at D = 64): bfloat16 inputs by cp.async
//      straight in, float32 inputs by 16-byte loads, 12 in flight a thread,
//      rounded on the way. Shared memory 202,792 bytes at D = 128 (135,240
//      at D = 64): one CTA per SM;
//    - three consumer warpgroups wait for a tile (mbarrier full), run its
//      chains for the output halves 0-63 and 64-127 (wgmma m64n64k16; the
//      same chains as the full-width product, so the same bits), release
//      the tile (mbarrier empty) and store each half from registers while
//      the producer refills the stage. No CTA barrier in the loop;
//    - registers: setmaxnreg gives the producer 72 and the consumers 144 a
//      thread (32 accumulators, 32 chain partials, the fragments);
//      chip_smoke.py's build report requires no spills and HGMMA.
// 5. attn_bwd_bf16_dw_kernel: the weight gradients dW_i[j][c][f] =
//    sum over (row, t) of bf16(xpad_i)[t + j][c] bf16(d_i)[t][f] and db_i,
//    four [D x R] x [R x D] products per tap over R = rows * 12 pairs. Bound:
//    bytes (at PEMS08, batch 32: 184 MB read once and the partials against
//    2.6e10 flops). The design reads each row once for all three taps and
//    overlaps the copies with the products:
//    - one CTA per (split, weight, 64 input channels): 256 threads, two
//      warpgroups splitting the outputs, wgmma m64n(D/2)k16 with both
//      operands in shared memory, MN-major (x^T and d(out) need no
//      transpose);
//    - a tile of 8 rows is 14 time slots a row: x with its zero halo (x[t]
//      at slot t + pad_left) and d(out) zero at its last two slots, so tap j
//      is a fixed offset of j slots (16 bytes) in A's descriptor. The 14/12
//      extra products meet a zero d(out); a non-finite x stays non-finite
//      in dW (it can reach one more tap's dW than in the plain sum);
//    - a ring of 3 stages filled by cp.async (two tiles in flight while the
//      tensor cores run one): x's 64 channels as they are (float32 mq, mk,
//      vs or bfloat16 x_attn) into a staging buffer, rounded into one of two
//      bfloat16 A tiles while the tile before runs its first two chains; d(out)
//      straight into its operand layout;
//    - nine chains a tile (k-steps {0, 1, 2}, {3, 4, 5}, {6} x 3 taps), two
//      in flight, each added to its tap's float32 sum on the CUDA cores;
//    - registers: 3 taps x D/4 accumulators + 2 chains x D/4 (160 at
//      D = 128, 80 at 64); ptxas: 237 and 155 registers, no spills (a
//      96-byte stack frame: the argument arrays indexed by blockIdx.y),
//      HGMMA in both (chip_smoke.py's build report); one CTA per SM
//      (190,976 bytes of shared memory at D = 128);
//    - splits from the SM count (ops/attn.py::bf16_dw_splits): one wave of
//      CTAs, whole tiles per split (16 splits at PEMS08, 43 tiles each).
//    Each CTA writes its D/64 x D rows of the three taps' D x D tiles as a
//    partial; the channel-block-0 CTAs also the bias partial.
// 6. attn_bwd_bf16_sum_kernel sums the partials of the splits in split
//    order.
//
// Dropout form (has_dropout=True, entry pxt_attn_bwd_bf16_dropout): the
// keep mask m [rows, T, H*T] (float32, pre-scaled {0, 1/keep}, head-major)
// enters only the core, the DROP instantiation of attn_bwd_bf16_core_kernel,
// which stages each row's m in shared memory: x_attn = bf16(bf16(p m) v_h),
// dv_h = (p m)^T dx_attn_h with the float32 p m, dp = (dx_attn_h v_h^T) m,
// ds from the pre-dropout p.
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
using tc16::bank_index;
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

constexpr int PRODUCERS = 128;                    // the conv kernel's producer warpgroup
constexpr int CONV_THREADS = THREADS + PRODUCERS;  // three consumer warpgroups first
// registers a thread after setmaxnreg: the producer's 12 loads in flight
// and their addresses; the consumers' 32 + 32 accumulators, fragments and
// epilogue (72 x 128 + 144 x 384 <= 65,536)
constexpr int PRODUCER_REGS = 72;
constexpr int CONSUMER_REGS = 144;

// the conv kernel's ring of x tiles: two at D = 128 (the bank and two tiles
// are 202,752 bytes), four at D = 64
template <int D>
constexpr int CONV_STAGES = D == 128 ? 2 : 4;

template <int D>
struct ConvSmem {
  uint16_t w[Geo<D>::BANK];                  // the job's bank, resident
  uint16_t x[CONV_STAGES<D>][M][Geo<D>::S];  // the ring of bfloat16 x tiles
  uint64_t bank_full;
  uint64_t full[CONV_STAGES<D>];   // a tile is in (PRODUCERS arrivals)
  uint64_t empty[CONV_STAGES<D>];  // the consumers are done with it (THREADS arrivals)
};

// a[i] of a kernel parameter's array, with constant offsets (an index into
// the parameter space would copy the array to the stack)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// producer thread pt of PRODUCERS: its part of rows [row0, row0 + n_rows)
// of src [rows, T, D] -> the bfloat16 tile xs (zeros past n_rows), then its
// arrival on `full`. bfloat16 src: cp.async straight in, the arrival made
// when the copies land; float32 src: 16-byte loads, 12 in flight a thread,
// rounded on the way in
template <int D>
__device__ __forceinline__ void fill_tile(uint16_t (*xs)[Geo<D>::S], const void* src, bool bf16,
                                          int64_t row0, int n_rows, uint64_t* full, int pt) {
  const int np = n_rows * T;
  if (bf16) {
    const uint16_t* base = static_cast<const uint16_t*>(src) + row0 * T * D;
    for (int u = pt; u < M * (D / 8); u += PRODUCERS) {
      const int pos = u / (D / 8), q = u % (D / 8);
      const bool ok = pos < np;
      tc::cp_async16_zfill(&xs[pos][8 * q], base + (ok ? (int64_t)pos * D + 8 * q : 0), ok);
    }
    tc16::barrier_arrive_cp_async(full);
    return;
  }
  constexpr int PER = M * (D / 4) / PRODUCERS;  // 48 or 24
  constexpr int BATCH = 12;
  static_assert(PER % BATCH == 0, "whole batches of loads");
  const float* base = static_cast<const float*>(src) + row0 * T * D;
#pragma unroll 1
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int u = pt + PRODUCERS * (b0 + i);
      const int pos = u / (D / 4);
      v[i] = pos < np ? __ldg(reinterpret_cast<const float4*>(base + (int64_t)pos * D + 4 * (u % (D / 4))))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int u = pt + PRODUCERS * (b0 + i);
      *reinterpret_cast<uint2*>(&xs[u / (D / 4)][4 * (u % (D / 4))]) =
          make_uint2(tc16::pack_bf16(v[i].x, v[i].y), tc16::pack_bf16(v[i].z, v[i].w));
    }
  }
  tc16::barrier_arrive(full);
}

// The convs of one launch (kernel 2: q, k, v, dx_attn; kernel 4: dmq, dmk,
// dvs), persistent: CTA blockIdx.x takes job blockIdx.x / ctas and that
// job's tiles of 16 rows blockIdx.x % ctas, + ctas, ... (no tile left out,
// none taken twice: tests/test_torch_bf16_conv_ring.py). The job's bank is
// loaded once (bulk copies) and stays; the producer warpgroup fills the ring
// of x tiles; each consumer warpgroup waits for a tile, runs its 64
// positions' chains in two output halves at D = 128 (one at 64), releases
// the tile after the last half's chains and stores that half's outputs from
// registers while the producer refills the stage.
template <int D>
__global__ void __launch_bounds__(CONV_THREADS, 1)
attn_bwd_bf16_conv_kernel(ConvJobs jobs, int64_t rows, int ctas) {
  constexpr int ST = CONV_STAGES<D>;
  constexpr int HALVES = D / tc16::HALF;
  using G = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ConvSmem<D>& s = *reinterpret_cast<ConvSmem<D>*>(smem_raw);
  const int job = blockIdx.x / ctas;
  const int first = blockIdx.x % ctas;
  const int64_t tiles = (rows + ROWS - 1) / ROWS;
  const int ntiles = first < tiles ? (int)((tiles - 1 - first) / ctas + 1) : 0;
  if (threadIdx.x == 0) {
    tc16::barrier_init(&s.bank_full, 1);
    for (int st = 0; st < ST; ++st) {
      tc16::barrier_init(&s.full[st], PRODUCERS);
      tc16::barrier_init(&s.empty[st], THREADS);
    }
    tc16::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {
    // the producer warpgroup
    tc16::regs_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - THREADS;
    const void* X = pick(jobs.x, job);
    const bool x_bf16 = pick(jobs.x_bf16, job) != 0;
    if (pt == 0) {
      const uint16_t* bank = pick(jobs.w, job);
      tc16::barrier_expect(&s.bank_full, 2 * G::BANK);
      for (int c = 0; c < G::CHUNKS; ++c)
        tc16::bulk_copy(s.w + c * G::CHUNK, bank + c * G::CHUNK, 2 * G::CHUNK, &s.bank_full);
    }
    for (int n = 0; n < ntiles; ++n) {
      const int st = n % ST;
      if (n >= ST) tc16::barrier_wait(&s.empty[st], (n / ST - 1) & 1);
      const int64_t row0 = (first + (int64_t)n * ctas) * ROWS;
      fill_tile<D>(s.x[st], X, x_bf16, row0, (int)min((int64_t)ROWS, rows - row0), &s.full[st], pt);
    }
    tc::cp_async_wait_all();
    return;
  }

  // the consumer warpgroups
  tc16::regs_inc<CONSUMER_REGS>();
  const float* __restrict__ bias = pick(jobs.b, job);
  void* out = pick(jobs.out, job);
  const int padl = pick(jobs.padl, job);
  const int tq = threadIdx.x & 3;
  const int p0 = tc::frag_row();
  tc16::barrier_wait(&s.bank_full, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int st = n % ST;
    const int64_t row0 = (first + (int64_t)n * ctas) * ROWS;
    const int np = (int)min((int64_t)ROWS, rows - row0) * T;
    tc16::barrier_wait(&s.full[st], (n / ST) & 1);
#pragma unroll 1
    for (int half = 0; half < HALVES; ++half) {
      float acc[tc16::HALF / 2];
      tc16::conv_half<D>(s.x[st], s.w, half, padl, acc);
      if (half == HALVES - 1) tc16::barrier_arrive(&s.empty[st]);
#pragma unroll
      for (int nb = 0; nb < tc16::HALF / 8; ++nb) {
        const int f = half * tc16::HALF + nb * 8 + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = p0 + 8 * h;
          if (pos >= np) continue;
          const int64_t off = (row0 * T + pos) * D + f;
          const float v0 = acc[4 * nb + 2 * h], v1 = acc[4 * nb + 2 * h + 1];
          if (bias != nullptr) {
            // bf16(bf16(acc) + bf16(bias)), as _tconv_tile
            const float b0 = tc16::round_bf16(__ldg(bias + f));
            const float b1 = tc16::round_bf16(__ldg(bias + f + 1));
            *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + off) =
                tc16::pack_bf16(tc16::round_bf16(v0) + b0, tc16::round_bf16(v1) + b1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
          }
        }
      }
    }
  }
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

// the keep masks of the core's rows with DROP, after CoreSmem: [CW][H][T][T]
template <int D, bool DROP>
constexpr int core_smem_bytes() {
  return (int)sizeof(CoreSmem<D>) + (DROP ? CW * Geo<D>::H * T * T * (int)sizeof(float) : 0);
}

template <int D, bool MASK, bool DROP>
__global__ void __launch_bounds__(CW * 32)
attn_bwd_bf16_core_kernel(CoreArgs io, const float* __restrict__ dm, int64_t rows) {
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

  // x_attn = bf16(bf16(P) V) (the out conv's input, for its weight
  // gradient); with DROP bf16(bf16(P m) V)
  if (live) {
#pragma unroll
    for (int tq = 0; tq < T; ++tq) {
      float o[FPL];
#pragma unroll
      for (int e = 0; e < FPL; ++e) o[e] = 0.f;
#pragma unroll
      for (int tk = 0; tk < T; ++tk) {
        const float pw = tc16::round_bf16(DROP ? sp[head][tq][tk] * smk[head][tq][tk]
                                               : sp[head][tq][tk]);
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pw, st[tk][lane * FPL + e], o[e]);
      }
      st_bf16(io.xatt + (row * T + tq) * D + lane * FPL, o);
    }
  }

  // dP = dx_attn V^T per head; with DROP dP m
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
      if (qd == 0) sdp[head][tq][tk] = DROP ? d * smk[head][tq][tk] : d;
    }
  }
  // dV = P^T dx_attn, with the float32 P (with DROP the float32 P m)
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

// A tile holds DR rows, each as TS = T + K - 1 time slots: x with its zero
// halo (x[t] at slot t + pad_left) and d(out) with zeros at its last K - 1
// slots. Pair k = row TS + t of the tile then meets x at slot k + j in tap
// j, a fixed offset, and the pairs with t >= T meet a zero d(out).
constexpr int DR = 8;             // rows per tile
constexpr int TS = T + K - 1;     // slots per row
constexpr int DSL = DR * TS;      // 112 slots: 7 k-steps of 16
constexpr int DKS = DSL / 16;
constexpr int DCB = 64;           // input channels per CTA (wgmma's M)
constexpr int DST = 3;            // stages of the copy ring
constexpr int DTHREADS = 256;     // two warpgroups
// 16-byte rows per column of 8 channels (outputs): the slots, the taps'
// overhang (K - 1 zero slots), and an odd count, so that eight consecutive
// columns start on distinct 16-byte bank groups
constexpr int XCOL = DSL + K;     // 115
constexpr int GCOL = DSL + 1;     // 113
static_assert(DSL % 16 == 0, "a tile is whole k-steps");
static_assert(DKS == 7 && K == 3, "the chains below take k-steps {0, 1, 2}, {3, 4, 5}, {6} of three taps");

template <int D>
struct DwSmem {
  float xraw[DST][DR * T][DCB];  // the CTA's channels of x as they arrive (a bfloat16 x: the first half)
  uint4 b[DST][D / 8][GCOL];     // bf16(d(out)) [8 outputs][slot]: MN-major core matrices
  uint4 a[2][DCB / 8][XCOL];     // bf16(x) with its halo [8 channels][slot]: MN-major
  float bias[DTHREADS];          // the bias sums' parts
};

// descriptor of an MN-major bfloat16 operand without swizzle: core matrices
// of 8 k (16-byte rows of 8 consecutive M or N elements) contiguous along k
// (leading byte offset 128), the groups of 8 M or N `sbo` bytes apart
__device__ __forceinline__ uint64_t desc_mn(const void* p, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= a b on an m64nNk16 tile, A and B from shared memory, both
// MN-major (imm-trans-a = imm-trans-b = 1); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n32(d, da, db, scale_d);
}

// wait until at most one committed wgmma group is in flight
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(DST - 2));
}

// tile rows [r0, r0 + n) -> stage st (cp.async, zeros past n; not
// committed): the CTA's DCB channels of x as they are, and bf16(d(out))
// straight into its operand layout (slot row TS + t)
template <int D>
__device__ __forceinline__ void dw_load(DwSmem<D>& s, int st, const void* X, bool x_bf16,
                                        const uint16_t* __restrict__ Gr, int cb, int64_t r0, int n) {
  const int np = n * T;
  unsigned char* xr = reinterpret_cast<unsigned char*>(&s.xraw[st][0][0]);
  if (x_bf16) {
    const uint16_t* src = static_cast<const uint16_t*>(X) + r0 * T * D + cb * DCB;
    for (int u = threadIdx.x; u < DR * T * (DCB / 8); u += DTHREADS) {
      const int p = u / (DCB / 8), q = u % (DCB / 8);
      const bool full = p < np;
      tc::cp_async16_zfill(xr + p * (2 * DCB) + 16 * q, src + (full ? p * D + 8 * q : 0), full);
    }
  } else {
    const float* src = static_cast<const float*>(X) + r0 * T * D + cb * DCB;
    for (int u = threadIdx.x; u < DR * T * (DCB / 4); u += DTHREADS) {
      const int p = u / (DCB / 4), q = u % (DCB / 4);
      const bool full = p < np;
      tc::cp_async16_zfill(xr + p * (4 * DCB) + 16 * q, src + (full ? p * D + 4 * q : 0), full);
    }
  }
  const uint16_t* gsrc = Gr + r0 * T * D;
  for (int u = threadIdx.x; u < DR * T * (D / 8); u += DTHREADS) {
    const int p = u / (D / 8), fb = u % (D / 8);
    const bool full = p < np;
    tc::cp_async16_zfill(&s.b[st][fb][(p / T) * TS + p % T], gsrc + (full ? p * D + 8 * fb : 0), full);
  }
}

// stage st's x -> A buffer ab, rounded to bfloat16: x[t] of a row at slot
// row TS + t + padl; the halo slots are never written (zero)
template <int D>
__device__ __forceinline__ void dw_convert(DwSmem<D>& s, int st, int ab, bool x_bf16, int padl) {
  const unsigned char* xr = reinterpret_cast<const unsigned char*>(&s.xraw[st][0][0]);
  for (int u = threadIdx.x; u < DR * T * (DCB / 8); u += DTHREADS) {
    const int p = u / (DCB / 8), c8 = u % (DCB / 8);
    uint4 v;
    if (x_bf16) {
      v = *reinterpret_cast<const uint4*>(xr + p * (2 * DCB) + 16 * c8);
    } else {
      const float4 f0 = *reinterpret_cast<const float4*>(xr + p * (4 * DCB) + 32 * c8);
      const float4 f1 = *reinterpret_cast<const float4*>(xr + p * (4 * DCB) + 32 * c8 + 16);
      v = make_uint4(tc16::pack_bf16(f0.x, f0.y), tc16::pack_bf16(f0.z, f0.w),
                     tc16::pack_bf16(f1.x, f1.y), tc16::pack_bf16(f1.z, f1.w));
    }
    s.a[ab][c8][(p / T) * TS + p % T + padl] = v;
  }
}

// part[split][(i K + j) D D + c D + f] = sum over the split's rows and steps
// t of bf16(xpad_i)[t + j][c] bf16(g_i)[t][f] for the CTA's channels c; the
// channel-block-0 CTAs also write part[split][4 K D D + i D + f] = sum of
// bf16(g_i)[t][f]. blockIdx.x = split (D / 64) + channel block, blockIdx.y =
// i. Warpgroup w takes the outputs w D/2 .. (w + 1) D/2 - 1 of all three
// taps (wgmma m64n(D/2)k16, M = channels, N = outputs, K = pairs, both
// operands MN-major in shared memory). A ring of DST stages keeps the next
// two tiles' copies in flight while the tensor cores run this one; the next
// tile's x is rounded into the other A buffer while this one's first two
// chains run.
template <int D>
__global__ void __launch_bounds__(DTHREADS, 1)
attn_bwd_bf16_dw_kernel(DwArgs args, int64_t rows, int64_t rows_per_split, float* __restrict__ part) {
  constexpr int NW = D / 2;   // outputs per warpgroup
  constexpr int NA = NW / 2;  // accumulator registers of one m64nNW tile
  constexpr int BP = DTHREADS / D;  // parts of a bias sum
  constexpr int64_t L = 4 * (int64_t)K * D * D + 4 * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DwSmem<D>& s = *reinterpret_cast<DwSmem<D>*>(smem_raw);
  const int cb = blockIdx.x % (D / DCB);
  const int64_t split = blockIdx.x / (D / DCB);
  const int wi = blockIdx.y;
  const void* X = args.x[wi];
  const bool x_bf16 = args.x_bf16[wi] != 0;
  const uint16_t* __restrict__ Gr = args.g[wi];
  const int padl = args.padl[wi];
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min(rows, r_begin + rows_per_split);
  const int ntiles = r_end > r_begin ? (int)((r_end - r_begin + DR - 1) / DR) : 0;
  const int wg = threadIdx.x >> 7;
  const bool bias_cta = cb == 0;
  const int bf = threadIdx.x % D;  // a bias thread's output and its part of the slots
  const int bpart = threadIdx.x / D;

  // the halo slots, the overhang and the rows past a ragged end stay zero
  for (int u = threadIdx.x; u < (int)(sizeof(s.a) / 16); u += DTHREADS)
    (&s.a[0][0][0])[u] = make_uint4(0u, 0u, 0u, 0u);
  for (int u = threadIdx.x; u < (int)(sizeof(s.b) / 16); u += DTHREADS)
    (&s.b[0][0][0])[u] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load = [&](int tile) {
    if (tile < ntiles) {
      const int64_t r0 = r_begin + (int64_t)tile * DR;
      dw_load<D>(s, tile % DST, X, x_bf16, Gr, cb, r0, (int)min((int64_t)DR, r_end - r0));
    }
    tc::cp_async_commit();
  };
  for (int t = 0; t < DST - 1; ++t) load(t);
  cp_async_wait_ring();
  __syncthreads();
  if (ntiles > 0) dw_convert<D>(s, 0, 0, x_bf16, padl);
  tc::fence_proxy_async();
  __syncthreads();

  float acc[K][NA], cx[NA], cy[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[0][i] = acc[1][i] = acc[2][i] = 0.f;
    cx[i] = cy[i] = 0.f;
  }
  float bsum = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int st = n % DST;
    load(n + DST - 1);
    const uint64_t da = desc_mn(&s.a[n & 1][0][0], XCOL * 16);
    const uint64_t db = desc_mn(&s.b[st][wg * (NW / 8)][0], GCOL * 16);
    // a chain: tap j over the k-steps of group grp ({0, 1, 2}, {3, 4, 5},
    // {6}), started afresh; the descriptors advance 16 bytes a slot
    auto issue = [&](float (&ch)[NA], int grp, int j) {
#pragma unroll
      for (int i = 0; i < NA; ++i) tc::hold(ch[i]);
      tc::wgmma_fence();
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int ks = 3 * grp + q;
        if (ks < DKS) wgmma_ss<NW>(ch, da + (uint64_t)(j + 16 * ks), db + (uint64_t)(16 * ks), q > 0);
      }
      tc::wgmma_commit();
    };
    // a finished chain into its tap's float32 sum on the CUDA cores
    auto flush = [&](float (&ch)[NA], float (&sum)[NA]) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        tc::hold(ch[i]);
        sum[i] += ch[i];
      }
    };

    // nine chains (k-step group, tap), two in flight: cx and cy in turn
    issue(cx, 0, 0);
    issue(cy, 0, 1);
    // while the first two run: the bias sum of this tile, then the next
    // tile's x rounded into the other A buffer
    if (bias_cta) {
      const uint16_t* col = reinterpret_cast<const uint16_t*>(&s.b[st][bf >> 3][0]) + (bf & 7);
#pragma unroll 4
      for (int k = bpart * (DSL / BP); k < (bpart + 1) * (DSL / BP); ++k) bsum += tc16::from_bf16(col[8 * k]);
    }
    cp_async_wait_ring();
    __syncthreads();
    if (n + 1 < ntiles) dw_convert<D>(s, (n + 1) % DST, (n + 1) & 1, x_bf16, padl);
    wgmma_wait_1();
    flush(cx, acc[0]);
    issue(cx, 0, 2);
    wgmma_wait_1();
    flush(cy, acc[1]);
    issue(cy, 1, 0);
    wgmma_wait_1();
    flush(cx, acc[2]);
    issue(cx, 1, 1);
    wgmma_wait_1();
    flush(cy, acc[0]);
    issue(cy, 1, 2);
    wgmma_wait_1();
    flush(cx, acc[1]);
    issue(cx, 2, 0);
    wgmma_wait_1();
    flush(cy, acc[2]);
    issue(cy, 2, 1);
    wgmma_wait_1();
    flush(cx, acc[0]);
    issue(cx, 2, 2);
    wgmma_wait_1();
    flush(cy, acc[1]);
    tc::wgmma_wait_all();
    flush(cx, acc[2]);
    tc::fence_proxy_async();  // the converted tile, for the next iteration's wgmma
    __syncthreads();
  }

  float* out = part + split * L + (int64_t)wi * K * D * D;
  const int c0 = cb * DCB + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int f0 = wg * NW + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int nb = 0; nb < NW / 8; ++nb) {
      float* o = out + (int64_t)j * D * D + (int64_t)c0 * D + f0 + 8 * nb;
      *reinterpret_cast<float2*>(o) = make_float2(acc[j][4 * nb], acc[j][4 * nb + 1]);
      *reinterpret_cast<float2*>(o + 8 * D) = make_float2(acc[j][4 * nb + 2], acc[j][4 * nb + 3]);
    }
  if (bias_cta) {
    s.bias[threadIdx.x] = bsum;
    __syncthreads();
    if (threadIdx.x < D) {
      float b = 0.f;
#pragma unroll
      for (int q = 0; q < BP; ++q) b += s.bias[q * D + threadIdx.x];
      part[split * L + 4 * (int64_t)K * D * D + wi * D + threadIdx.x] = b;
    }
  }
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

template <int D, bool MASK, bool DROP>
int launch_core(const CoreArgs& io, const float* dm, int64_t rows, cudaStream_t stream) {
  constexpr int smem = core_smem_bytes<D, DROP>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_bf16_core_kernel<D, MASK, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_core_kernel<D, MASK, DROP><<<(unsigned)((rows + CW - 1) / CW), CW * 32, smem,
                                             stream>>>(io, dm, rows);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch(const void* const* p, const float* dm, void* const* out, unsigned char* scratch,
           int64_t rows, int splits, const int (&conv_ctas)[2], int causal_q, int causal_kv,
           cudaStream_t stream) {
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
  err = cudaFuncSetAttribute(attn_bwd_bf16_conv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, conv_smem);
  if (err != cudaSuccess) return (int)err;
  ConvJobs fwd = {{mq, mk, vs, g},
                  {0, 0, 0, 1},
                  {ws, ws + BANK, ws + 2 * BANK, ws + 3 * BANK},
                  {(const float*)p[4], (const float*)p[6], (const float*)p[8], nullptr},
                  {q, k, v, dxa},
                  {pq, pkv, pkv, K - 1 - PAD_SAME}};
  attn_bwd_bf16_conv_kernel<D><<<4 * conv_ctas[0], CONV_THREADS, conv_smem, stream>>>(
      fwd, rows, conv_ctas[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CoreArgs io = {q, k, v, dxa, xatt, dq, dk, dv};
  const int core_err = causal_q && causal_kv ? launch_core<D, true, DROP>(io, dm, rows, stream)
                                             : launch_core<D, false, DROP>(io, dm, rows, stream);
  if (core_err != 0) return core_err;

  ConvJobs bwd = {{dq, dk, dv, nullptr},
                  {1, 1, 1, 1},
                  {ws + 4 * BANK, ws + 5 * BANK, ws + 6 * BANK, nullptr},
                  {nullptr, nullptr, nullptr, nullptr},
                  {out[0], out[1], out[2], nullptr},
                  {K - 1 - pq, K - 1 - pkv, K - 1 - pkv, 0}};
  attn_bwd_bf16_conv_kernel<D><<<3 * conv_ctas[1], CONV_THREADS, conv_smem, stream>>>(
      bwd, rows, conv_ctas[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwArgs args = {{mq, mk, vs, xatt}, {0, 0, 0, 1}, {dq, dk, dv, g}, {pq, pkv, pkv, PAD_SAME}};
  const int dw_smem = (int)sizeof(DwSmem<D>);
  const int64_t dw_tiles = (rows + DR - 1) / DR;
  const int64_t rows_per_split = DR * ((dw_tiles + splits - 1) / splits);
  err = cudaFuncSetAttribute(attn_bwd_bf16_dw_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_dw_kernel<D><<<dim3((D / DCB) * splits, 4), DTHREADS, dw_smem, stream>>>(
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
// aligned); splits: the weight-gradient kernel's row splits; ctas4, ctas3:
// the conv kernel's CTAs per job in its 4-job and 3-job launches (each at
// least 1, at most the tiles of 16 rows); d = 64 or 128 with head dim 16
extern "C" int pxt_attn_bwd_bf16(const void* const* p, void* const* out, void* scratch,
                                 int64_t rows, int splits, int ctas4, int ctas3, int d,
                                 int causal_q, int causal_kv, int is_mask, void* stream) {
  if (rows <= 0 || splits <= 0 || ctas4 <= 0 || ctas3 <= 0 || !flags_ok(causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = (unsigned char*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  const int ctas[2] = {ctas4, ctas3};
  if (d == 128) return launch<128, false>(p, nullptr, out, sc, rows, splits, ctas, causal_q, causal_kv, s);
  if (d == 64) return launch<64, false>(p, nullptr, out, sc, rows, splits, ctas, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

// the dropout form; dmask: float32 [rows, 12, (d / 16) * 12]
extern "C" int pxt_attn_bwd_bf16_dropout(const void* const* p, const void* dmask,
                                         void* const* out, void* scratch, int64_t rows,
                                         int splits, int ctas4, int ctas3, int d, int causal_q,
                                         int causal_kv, int is_mask, void* stream) {
  if (rows <= 0 || splits <= 0 || ctas4 <= 0 || ctas3 <= 0 || !flags_ok(causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  unsigned char* sc = (unsigned char*)scratch;
  const float* dm = (const float*)dmask;
  cudaStream_t s = (cudaStream_t)stream;
  const int ctas[2] = {ctas4, ctas3};
  if (d == 128) return launch<128, true>(p, dm, out, sc, rows, splits, ctas, causal_q, causal_kv, s);
  if (d == 64) return launch<64, true>(p, dm, out, sc, rows, splits, ctas, causal_q, causal_kv, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
