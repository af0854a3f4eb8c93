// Fused temporal-context attention block (forward) in bfloat16, for Hopper
// (sm_90a).
//
// Replaces the bfloat16 form (dtype_name="bfloat16") of the Pallas TPU kernel
// paddlexde_tpu/ops/attn_pallas.py (_fwd_kernel, launched by _call_fwd for
// fused_temporal_attention). Per (batch, node) row, on [T, D] tiles, with the
// TPU kernel's rounding points:
//
//   q = conv(mq; Wq, bq, causal_q)  k = conv(mk; ...)  v = conv(vs; ...)
//   conv(x; W, b) = bf16(bf16(sum_j bf16(x)[t + j - pad] bf16(W[j])) + bf16(b))
//                   (float32 sums; the bias added in bfloat16: _tconv_tile)
//   s = q_h k_h^T * (1/sqrt(dh)) [+ finfo(f32).min above the diagonal]
//   p = exp(s - max over every head of the query step) / sum over the head
//   y = conv(bf16(bf16(p) v_h); Wo, bo, same padding)   (_blockdiag_state)
//
// Dropout form (has_dropout=True, entry pxt_attn_fwd_bf16_dropout, the DROP
// instantiation): a float32 keep mask m [rows, T, H*T], pre-scaled {0,
// 1/keep} and head-major, enters at the softmax: the value product takes
// bf16(p m), the float32 product rounded once (not bf16(p) m).
//
// Activations float32 (what D3STN passes) or bfloat16 converted by the
// caller; y bfloat16. Shapes: T = 12, K = 3, head dim 16, D = 128 (8 heads)
// or 64 (4 heads), D3STN's three flag sets.
//
// Bound: bytes (117 MB at PEMS08, batch 32: 0.035 ms at 3.35 TB/s; the
// products of the four convs, 98% of the work, take less on the tensor
// cores in bfloat16). The convs run as wgmma m64nDk16 (one product where
// the float32 kernel attn.cu needs three), the attention core on the CUDA
// cores.
//   - attn_bf16_wcast_kernel rounds the four weight banks to bfloat16 once
//     per call, in the order the tensor cores read them (scratch from the
//     caller): chunk of 16 input channels, tap, then K-major core matrices
//     over the inputs (tc_bf16.cuh). The four banks are contiguous, so the
//     kernel's four convs read one run of 4 D / 16 chunks.
//   - attn_bf16_fwd_kernel: one CTA of three warpgroups per 16 (batch,
//     node) rows (192 positions, no padding). mq and mk are rounded into
//     two bfloat16 shared tiles; the q and k convs run in place; the
//     scores go to a shared [16, H, T, T] buffer with each head's row
//     maximum, then their softmax as bf16(p); vs is rounded over q, its
//     conv runs in place and is replaced by P v column by column; the out
//     conv writes y.
//   - The convs (tc_bf16_conv.cuh, conv_ring): the weight chunks (12,288
//     bytes at D = 128) pass through a ring of 3 stages filled by one
//     thread's bulk copies and handed over by mbarriers, running on across
//     the four convs, so a conv's first chunks land during the previous
//     conv's tail and the attention core. One CTA barrier per conv (its
//     tile is overwritten in place after it), none per chunk. Each chunk of
//     16 input channels x 3 taps starts a fresh accumulator, added in
//     float32 on the CUDA cores in chunk order: the parent's chains, the
//     parent's bits.
//   - Shared memory at D = 128: two tiles 104,448 bytes, the ring 36,912,
//     the scores 73,728 and maxima 6,144: 221,232 bytes, one CTA per SM
//     (D = 64: 113,712). What still bounds it: the CUDA-core middle leaves
//     the tensor cores and the copies idle (nothing else is resident), and
//     340 CTAs are 2.6 waves on 132 SMs (ROADMAP.md, §2.B).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16_conv.cuh"

namespace {

constexpr int T = tc::T, K = tc::K;
using tc16::bank_index;
using tc16::DH;
using tc16::Geo;
using tc16::M;
using tc16::ROWS;
using tc16::THREADS;

template <int D>
struct Smem {
  using G = Geo<D>;
  uint16_t a[M][G::S];        // mq -> q, then vs -> v -> P v
  uint16_t b[M][G::S];        // mk -> k
  tc16::WRing<D> w;           // the weight chunks of the four convs, in turn
  float p[ROWS][G::H][T][T];  // scores, then bf16(p)
  float hmax[ROWS][T][G::H];  // each head's row maximum of the scores
};

// the four [K, D, D] float32 banks -> bfloat16 banks in bank_index order
template <int D>
__global__ void attn_bf16_wcast_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                                       const float* __restrict__ wv, const float* __restrict__ wo,
                                       uint16_t* __restrict__ ws) {
  constexpr int W = Geo<D>::BANK;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * W) return;
  const int i = idx / W;
  const int r = idx - i * W;
  const float* w = i == 0 ? wq : i == 1 ? wk : i == 2 ? wv : wo;
  ws[i * W + bank_index<D>(r / (D * D), (r / D) % D, r % D)] = tc16::bits_bf16(w[r]);
}

// rows [row0, row0 + ROWS) of src [rows, T, D] float32 -> the bfloat16
// tile, zeros past n_rows, a piece at a time (for mq and mk, batching all of
// a thread's loads into registers first spills; for vs it is no faster
// beyond noise)
template <int D>
__device__ __forceinline__ void stage(uint16_t (*xs)[Geo<D>::S], const float* __restrict__ src,
                                      int64_t row0, int n_rows) {
  const float* base = src + row0 * T * D;
  for (int u = threadIdx.x; u < M * (D / 4); u += THREADS) {
    const int pos = u / (D / 4);
    const int q = u % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < n_rows * T) v = __ldg(reinterpret_cast<const float4*>(base + (int64_t)pos * D + 4 * q));
    *reinterpret_cast<uint2*>(&xs[pos][4 * q]) =
        make_uint2(tc16::pack_bf16(v.x, v.y), tc16::pack_bf16(v.z, v.w));
  }
}

// visit the conv's outputs with the bias: fn(pos, f, v0, v1) for (pos, f)
// and (pos, f + 1), v = bf16(bf16(acc) + bf16(bias)) as a float
template <int D, typename Fn>
__device__ __forceinline__ void epilogue(const float (&acc)[D / 2], const float* __restrict__ bias,
                                         Fn fn) {
  const int tq = threadIdx.x & 3;
  const int p0 = tc::frag_row();
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int f = nb * 8 + 2 * tq;
    const float b0 = tc16::round_bf16(__ldg(bias + f));
    const float b1 = tc16::round_bf16(__ldg(bias + f + 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = p0 + 8 * h;
      if (pos < M)
        fn(pos, f, tc16::round_bf16(tc16::round_bf16(acc[4 * nb + 2 * h]) + b0),
           tc16::round_bf16(tc16::round_bf16(acc[4 * nb + 2 * h + 1]) + b1));
    }
  }
}

template <int D>
__device__ __forceinline__ void store_tile(uint16_t (*xs)[Geo<D>::S], const float (&acc)[D / 2],
                                           const float* __restrict__ bias) {
  epilogue<D>(acc, bias, [&](int pos, int f, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(&xs[pos][f]) = tc16::pack_bf16(v0, v1);
  });
}

// scores of the tile's q (s.a) and k (s.b) per (row, head, query step),
// scaled and masked, and each head's row maximum
template <int D, bool MASK>
__device__ __forceinline__ void scores(Smem<D>& s) {
  constexpr int H = Geo<D>::H;
  const float inv = 0.25f;  // 1 / sqrt(16)
  for (int item = threadIdx.x; item < ROWS * H * T; item += THREADS) {
    const int i = item % T;
    const int h = (item / T) % H;
    const int r = item / (T * H);
    float q[DH];
    const uint16_t* qrow = &s.a[r * T + i][h * DH];
#pragma unroll
    for (int e = 0; e < DH; e += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(qrow + e);
      q[e] = tc16::lo_bf16(v);
      q[e + 1] = tc16::hi_bf16(v);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint16_t* krow = &s.b[r * T + j][h * DH];
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < DH; e += 2) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(krow + e);
        d = fmaf(q[e], tc16::lo_bf16(v), d);
        d = fmaf(q[e + 1], tc16::hi_bf16(v), d);
      }
      d *= inv;
      if (MASK && j > i) d += -FLT_MAX;
      s.p[r][h][i][j] = d;
      mx = fmaxf(mx, d);
    }
    s.hmax[r][i][h] = mx;
  }
}

// p = bf16(exp(s - max over the query step's heads) / sum over the head);
// with DROP bf16(p m), m the keep mask's row dm[row][i][h T .. h T + T)
template <int D, bool DROP>
__device__ __forceinline__ void softmax(Smem<D>& s, const float* __restrict__ dm, int64_t row0,
                                        int n_rows) {
  constexpr int H = Geo<D>::H;
  for (int item = threadIdx.x; item < ROWS * H * T; item += THREADS) {
    const int i = item % T;
    const int h = (item / T) % H;
    const int r = item / (T * H);
    float mx = s.hmax[r][i][0];
#pragma unroll
    for (int g = 1; g < H; ++g) mx = fmaxf(mx, s.hmax[r][i][g]);
    float* row = s.p[r][h][i];
    float e[T];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      e[j] = expf(row[j] - mx);
      sum += e[j];
    }
    const float rsum = __frcp_rn(sum);
    if (DROP) {
      float m[T];
#pragma unroll
      for (int j = 0; j < T; ++j) m[j] = 0.f;
      if (r < n_rows) {
        const float* mrow = dm + ((row0 + r) * T + i) * (H * T) + h * T;
#pragma unroll
        for (int j = 0; j < T; j += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(mrow + j));
          m[j] = v.x; m[j + 1] = v.y; m[j + 2] = v.z; m[j + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < T; ++j) row[j] = tc16::round_bf16(tc16::div_rn(e[j], sum, rsum) * m[j]);
    } else {
#pragma unroll
      for (int j = 0; j < T; ++j) row[j] = tc16::round_bf16(tc16::div_rn(e[j], sum, rsum));
    }
  }
}

// s.a (v) <- bf16(P v), one (row, feature) column per step: a column reads
// and writes only itself, so the update is in place
template <int D>
__device__ __forceinline__ void apply_p(Smem<D>& s) {
  for (int col = threadIdx.x; col < ROWS * D; col += THREADS) {
    const int f = col % D;
    const int r = col / D;
    float v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = tc16::from_bf16(s.a[r * T + j][f]);
    const float* pr = &s.p[r][f / DH][0][0];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) o = fmaf(pr[i * T + j], v[j], o);
      s.a[r * T + i][f] = tc16::bits_bf16(o);
    }
  }
}

template <int D, bool CQ, bool CKV, bool MASK, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
attn_bf16_fwd_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
                     const float* __restrict__ vs, const uint16_t* __restrict__ ws,
                     const float* __restrict__ bq, const float* __restrict__ bk,
                     const float* __restrict__ bv, const float* __restrict__ bo,
                     const float* __restrict__ dm, uint16_t* __restrict__ out, int64_t rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int PAD_SAME = (K - 1) / 2;
  constexpr int PQ = CQ ? K - 1 : PAD_SAME;
  constexpr int PKV = CKV ? K - 1 : PAD_SAME;
  constexpr int CH = Geo<D>::CHUNKS;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int n_rows = (int)min((int64_t)ROWS, rows - row0);
  float acc[D / 2];

  // the four banks are contiguous: 4 CH chunks through one ring
  tc16::ring_start<D>(s.w, ws, 4 * CH);
  stage<D>(s.a, mq, row0, n_rows);
  stage<D>(s.b, mk, row0, n_rows);
  __syncthreads();
  tc16::conv_ring<D>(s.a, s.w, ws, 0, 4 * CH, PQ, acc);
  store_tile<D>(s.a, acc, bq);
  tc16::conv_ring<D>(s.b, s.w, ws, CH, 4 * CH, PKV, acc);
  store_tile<D>(s.b, acc, bk);
  __syncthreads();
  scores<D, MASK>(s);
  __syncthreads();
  softmax<D, DROP>(s, dm, row0, n_rows);
  stage<D>(s.a, vs, row0, n_rows);  // q is done with
  __syncthreads();
  tc16::conv_ring<D>(s.a, s.w, ws, 2 * CH, 4 * CH, PKV, acc);
  store_tile<D>(s.a, acc, bv);
  __syncthreads();
  apply_p<D>(s);
  __syncthreads();
  tc16::conv_ring<D>(s.a, s.w, ws, 3 * CH, 4 * CH, PAD_SAME, acc);
  epilogue<D>(acc, bo, [&](int pos, int f, float v0, float v1) {
    if (pos < n_rows * T)
      *reinterpret_cast<uint32_t*>(out + (row0 * T + pos) * D + f) = tc16::pack_bf16(v0, v1);
  });
}

template <int D, bool CQ, bool CKV, bool MASK, bool DROP>
int launch(const void* const* p, const float* dm, void* out, uint16_t* ws, int64_t rows,
           cudaStream_t stream) {
  constexpr int W = Geo<D>::BANK;
  attn_bf16_wcast_kernel<D><<<(4 * W + 255) / 256, 256, 0, stream>>>(
      (const float*)p[3], (const float*)p[5], (const float*)p[7], (const float*)p[9], ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)sizeof(Smem<D>);
  err = cudaFuncSetAttribute(attn_bf16_fwd_kernel<D, CQ, CKV, MASK, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + ROWS - 1) / ROWS;
  attn_bf16_fwd_kernel<D, CQ, CKV, MASK, DROP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2], ws, (const float*)p[4],
      (const float*)p[6], (const float*)p[8], (const float*)p[10], dm, (uint16_t*)out, rows);
  return (int)cudaGetLastError();
}

// D3STN's three flag sets: encoder self-attention, decoder masked
// self-attention, decoder source attention
template <int D, bool DROP>
int dispatch(const void* const* p, const float* dm, void* out, uint16_t* ws, int64_t rows,
             int causal_q, int causal_kv, int is_mask, cudaStream_t stream) {
  if (!causal_q && !causal_kv && !is_mask)
    return launch<D, false, false, false, DROP>(p, dm, out, ws, rows, stream);
  if (causal_q && causal_kv && is_mask)
    return launch<D, true, true, true, DROP>(p, dm, out, ws, rows, stream);
  if (causal_q && !causal_kv && !is_mask)
    return launch<D, true, false, false, DROP>(p, dm, out, ws, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p: the 11 input pointers mq, mk, vs (float32 [rows, 12, d]), wq, bq, wk,
// bk, wv, bv, wo, bo (float32); out: bfloat16 [rows, 12, d]; scratch: 4 x 3
// d^2 bfloat16 (16-byte aligned); d = 64 or 128 with head dim 16
extern "C" int pxt_attn_fwd_bf16(const void* const* p, void* out, void* scratch, int64_t rows,
                                 int d, int causal_q, int causal_kv, int is_mask, void* stream) {
  if (rows == 0) return 0;
  uint16_t* ws = (uint16_t*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return dispatch<128, false>(p, nullptr, out, ws, rows, causal_q, causal_kv, is_mask, s);
  if (d == 64) return dispatch<64, false>(p, nullptr, out, ws, rows, causal_q, causal_kv, is_mask, s);
  return (int)cudaErrorInvalidValue;
}

// the dropout form; dmask: float32 [rows, 12, (d / 16) * 12]
extern "C" int pxt_attn_fwd_bf16_dropout(const void* const* p, const void* dmask, void* out,
                                         void* scratch, int64_t rows, int d, int causal_q,
                                         int causal_kv, int is_mask, void* stream) {
  if (rows == 0) return 0;
  uint16_t* ws = (uint16_t*)scratch;
  const float* dm = (const float*)dmask;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return dispatch<128, true>(p, dm, out, ws, rows, causal_q, causal_kv, is_mask, s);
  if (d == 64) return dispatch<64, true>(p, dm, out, ws, rows, causal_q, causal_kv, is_mask, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
