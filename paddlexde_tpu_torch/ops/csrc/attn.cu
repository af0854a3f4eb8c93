// Fused temporal-context attention block (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/attn_pallas.py
// (_fwd_kernel, launched by _call_fwd for fused_temporal_attention). Per
// (batch, node) row, on [T, D] tiles:
//
//   q = conv(mq; Wq, bq, causal_q)   k = conv(mk; Wk, bk, causal_kv)
//   v = conv(vs; Wv, bv, causal_kv)
//   a = softmax(q_h k_h^T / sqrt(dh) [+ finfo(f32).min above the diagonal])
//   y = conv(a v; Wo, bo, same padding)
//
// where conv(x; W, b)[t] = b + sum_j x[t + j - pad_left] W[j] over K taps
// (zero outside [0, T)), W[j] is [D_in, D_out], pad_left = K-1 (causal) or
// (K-1)/2 (same), and heads split the D features into H groups of dh.
//
// Design. One CTA per kNodes rows of the flattened (batch, node) axis, one
// thread per output feature (blockDim = D). The rows' inputs are staged in
// shared memory; each conv keeps the kNodes x T outputs of its feature in
// registers, reads W rows from global memory (the four [K, D, D] banks are
// 786 KB at D=128 and stay L2-resident; each weight read feeds kNodes * T
// FMAs) and the input tile with float4 broadcast reads from shared memory.
// q, k, v overwrite their own input tiles; the scores and their softmax live
// in a [kNodes, H, Tq, Tk] shared buffer; a v overwrites the q tile and feeds
// the out conv. Nothing but the inputs and y touches device memory.
//
// The TPU kernel's blockdiag/selector middle, [T, C] layout and VMEM tile
// caps are Mosaic workarounds and are not carried over. No dropout input.
//
// Bound: operations (the four convs, 8 K D^2 T flops per row, in float32 on
// the CUDA cores), against 4 T D floats moved per row.

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNodes = 4;

template <int TMAX>
__device__ __forceinline__ void conv_feature(const float* __restrict__ sin,
                                             int t_len,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias,
                                             int ks, int pad_l, int d, int f,
                                             float (&acc)[kNodes][TMAX]) {
#pragma unroll
  for (int g = 0; g < kNodes; ++g)
#pragma unroll
    for (int t = 0; t < TMAX; ++t) acc[g][t] = 0.f;
  for (int j = 0; j < ks; ++j) {
    const float* wj = w + (int64_t)j * d * d + f;
    for (int c = 0; c < d; c += 4) {
      const float w0 = __ldg(wj + (int64_t)(c + 0) * d);
      const float w1 = __ldg(wj + (int64_t)(c + 1) * d);
      const float w2 = __ldg(wj + (int64_t)(c + 2) * d);
      const float w3 = __ldg(wj + (int64_t)(c + 3) * d);
#pragma unroll
      for (int g = 0; g < kNodes; ++g) {
#pragma unroll
        for (int t = 0; t < TMAX; ++t) {
          const int src = t + j - pad_l;
          if (t < t_len && src >= 0 && src < t_len) {
            const float4 xv =
                *reinterpret_cast<const float4*>(sin + (g * t_len + src) * d + c);
            float a = acc[g][t];
            a = fmaf(xv.x, w0, a);
            a = fmaf(xv.y, w1, a);
            a = fmaf(xv.z, w2, a);
            a = fmaf(xv.w, w3, a);
            acc[g][t] = a;
          }
        }
      }
    }
  }
  const float bf = bias[f];
#pragma unroll
  for (int g = 0; g < kNodes; ++g)
#pragma unroll
    for (int t = 0; t < TMAX; ++t) acc[g][t] += bf;
}

template <int TMAX>
__device__ __forceinline__ void store_tile(float* s, int t_len, int d, int f,
                                           const float (&acc)[kNodes][TMAX]) {
#pragma unroll
  for (int g = 0; g < kNodes; ++g)
#pragma unroll
    for (int t = 0; t < TMAX; ++t)
      if (t < t_len) s[(g * t_len + t) * d + f] = acc[g][t];
}

template <int TMAX>
__global__ void attn_fwd_kernel(
    const float* __restrict__ mq, const float* __restrict__ mk,
    const float* __restrict__ vs, const float* __restrict__ wq,
    const float* __restrict__ bq, const float* __restrict__ wk,
    const float* __restrict__ bk, const float* __restrict__ wv,
    const float* __restrict__ bv, const float* __restrict__ wo,
    const float* __restrict__ bo, float* __restrict__ out, int64_t rows,
    int tq, int tk, int d, int heads, int ks, int causal_q, int causal_kv,
    int is_mask) {
  extern __shared__ float smem[];
  float* sq = smem;                     // [kNodes][tq][d]
  float* sk = sq + kNodes * tq * d;     // [kNodes][tk][d]
  float* sv = sk + kNodes * tk * d;     // [kNodes][tk][d]
  float* sp = sv + kNodes * tk * d;     // [kNodes][heads][tq][tk]
  const int f = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kNodes;
  const int n_rows = (int)min((int64_t)kNodes, rows - row0);

  for (int g = 0; g < kNodes; ++g) {
    const bool live = g < n_rows;
    for (int e = f; e < tq * d; e += d)
      sq[g * tq * d + e] = live ? mq[(row0 + g) * tq * d + e] : 0.f;
    for (int e = f; e < tk * d; e += d) {
      sk[g * tk * d + e] = live ? mk[(row0 + g) * tk * d + e] : 0.f;
      sv[g * tk * d + e] = live ? vs[(row0 + g) * tk * d + e] : 0.f;
    }
  }
  __syncthreads();

  const int pad_same = (ks - 1) / 2;
  float acc[kNodes][TMAX];
  conv_feature<TMAX>(sq, tq, wq, bq, ks, causal_q ? ks - 1 : pad_same, d, f, acc);
  __syncthreads();
  store_tile<TMAX>(sq, tq, d, f, acc);
  conv_feature<TMAX>(sk, tk, wk, bk, ks, causal_kv ? ks - 1 : pad_same, d, f, acc);
  __syncthreads();
  store_tile<TMAX>(sk, tk, d, f, acc);
  conv_feature<TMAX>(sv, tk, wv, bv, ks, causal_kv ? ks - 1 : pad_same, d, f, acc);
  __syncthreads();
  store_tile<TMAX>(sv, tk, d, f, acc);
  __syncthreads();

  // scores [g][h][i][j]
  const int dh = d / heads;
  const float scale = 1.f / sqrtf((float)dh);
  const int n_scores = kNodes * heads * tq * tk;
  for (int e = f; e < n_scores; e += d) {
    const int j = e % tk;
    const int i = (e / tk) % tq;
    const int h = (e / (tk * tq)) % heads;
    const int g = e / (tk * tq * heads);
    const float* qi = sq + (g * tq + i) * d + h * dh;
    const float* kj = sk + (g * tk + j) * d + h * dh;
    float s = 0.f;
    for (int c = 0; c < dh; ++c) s = fmaf(qi[c], kj[c], s);
    s *= scale;
    if (is_mask && j > i) s += -FLT_MAX;
    sp[e] = s;
  }
  __syncthreads();

  // row softmax over j
  for (int r = f; r < kNodes * heads * tq; r += d) {
    float* row = sp + r * tk;
    float mx = -INFINITY;
    for (int j = 0; j < tk; ++j) mx = fmaxf(mx, row[j]);
    float s = 0.f;
    for (int j = 0; j < tk; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      s += e;
    }
    for (int j = 0; j < tk; ++j) row[j] = row[j] / s;
  }
  __syncthreads();

  // (a v)[g][i][f] into the q tile (q is dead after the scores)
  const int h = f / dh;
#pragma unroll
  for (int g = 0; g < kNodes; ++g) {
    const float* pg = sp + (g * heads + h) * tq * tk;
    const float* vg = sv + g * tk * d + f;
#pragma unroll
    for (int i = 0; i < TMAX; ++i) {
      if (i < tq) {
        float a = 0.f;
        for (int j = 0; j < tk; ++j) a = fmaf(pg[i * tk + j], vg[j * d], a);
        acc[g][i] = a;
      }
    }
  }
  store_tile<TMAX>(sq, tq, d, f, acc);
  __syncthreads();

  conv_feature<TMAX>(sq, tq, wo, bo, ks, pad_same, d, f, acc);
#pragma unroll
  for (int g = 0; g < kNodes; ++g)
#pragma unroll
    for (int t = 0; t < TMAX; ++t)
      if (g < n_rows && t < tq) out[((row0 + g) * tq + t) * d + f] = acc[g][t];
}

template <int TMAX>
int launch(const void* const* p, void* out, int64_t rows, int tq, int tk,
           int d, int heads, int ks, int causal_q, int causal_kv, int is_mask,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<TMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + kNodes - 1) / kNodes;
  attn_fwd_kernel<TMAX><<<(unsigned)blocks, d, smem, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5],
      (const float*)p[6], (const float*)p[7], (const float*)p[8],
      (const float*)p[9], (const float*)p[10], (float*)out, rows, tq, tk, d,
      heads, ks, causal_q, causal_kv, is_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// D3STN shape: T = 12, D = 128, H = 8, K = 3 (every configuration the repo
// ships) and D3STN's three flag sets. One warp per (batch, node) row, 4 rows per CTA; lane l owns the
// output features 4l..4l+3 for all 12 time steps (48 accumulators), so the
// convs are register-tiled outer products: per input channel a lane reads
// the 12 input values (float4 broadcast reads of 4 channels at once) and 3
// float4 weight rows, and does up to 144 FMAs. The weight banks stream
// through shared memory in chunks of 8 input channels (cp.async, double
// buffered, shared by the 4 warps). q and k stay in registers: the head of
// lane l is l / 4, so a score is a 4-wide partial dot plus two xor shuffles.
// Each lane takes the softmax of 3 of its head's 12 rows and stores them in
// shared memory for the P @ V step; the attention output goes back through
// the warp's shared tile into the out conv. Padding taps (causal or same)
// are resolved at compile time.
// ---------------------------------------------------------------------------

namespace fast {

constexpr int T = 12, D = 128, H = 8, K = 3;
constexpr int DH = D / H;          // 16 features per head
constexpr int FPL = D / 32;        // 4 features per lane
constexpr int WARPS = 4;           // rows per CTA
constexpr int CC = 8;              // input channels per weight chunk
constexpr int CHUNKS = D / CC;
static_assert(DH / FPL == 4, "a head spans 4 lanes (two xor-shuffle steps)");

struct Smem {
  float x[WARPS][T][D];       // each warp's conv input tile
  float p[WARPS][H][T][T];    // each warp's softmax rows
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

// W [K, D, D] (tap, input, output) -> s.w[buf][cc][tap][:] for one chunk
__device__ __forceinline__ void load_chunk(Smem& s, const float* __restrict__ w,
                                           int chunk, int buf) {
  constexpr int kUnits = CC * K * (D / 4);
  for (int u = threadIdx.x; u < kUnits; u += blockDim.x) {
    const int q = u % (D / 4);
    const int r = u / (D / 4);
    const int tap = r % K;
    const int cc = r / K;
    cp_async16(&s.w[buf][cc][tap][q * 4],
               w + ((int64_t)tap * D + chunk * CC + cc) * D + q * 4);
  }
}

// acc[t][e] = bias + sum_{tap, c} x[t + tap - PADL][c] W[tap][c][4 lane + e]
// over the warp's tile s.x[warp]. Every thread of the CTA calls it.
template <int PADL>
__device__ __forceinline__ void conv(Smem& s, const float* __restrict__ w,
                                     const float* __restrict__ bias, int warp,
                                     int lane, float (&acc)[T][FPL]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int e = 0; e < FPL; ++e) acc[t][e] = 0.f;
  load_chunk(s, w, 0, 0);
  cp_async_commit();
  for (int ci = 0; ci < CHUNKS; ++ci) {
    if (ci + 1 < CHUNKS) load_chunk(s, w, ci + 1, (ci + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int buf = ci & 1;
#pragma unroll
    for (int cq = 0; cq < CC; cq += 4) {
      float4 wv[4][K];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int tap = 0; tap < K; ++tap)
          wv[cc][tap] = *reinterpret_cast<const float4*>(&s.w[buf][cq + cc][tap][lane * FPL]);
      const int c = ci * CC + cq;
#pragma unroll
      for (int src = 0; src < T; ++src) {
        const float4 xv = *reinterpret_cast<const float4*>(&s.x[warp][src][c]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int tap = 0; tap < K; ++tap) {
          const int t = src - tap + PADL;
          if (t >= 0 && t < T) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              acc[t][0] = fmaf(xs[cc], wv[cc][tap].x, acc[t][0]);
              acc[t][1] = fmaf(xs[cc], wv[cc][tap].y, acc[t][1]);
              acc[t][2] = fmaf(xs[cc], wv[cc][tap].z, acc[t][2]);
              acc[t][3] = fmaf(xs[cc], wv[cc][tap].w, acc[t][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + lane * FPL);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    acc[t][0] += b.x;
    acc[t][1] += b.y;
    acc[t][2] += b.z;
    acc[t][3] += b.w;
  }
}

// copy the warp's [T, D] input row into s.x[warp] (zeros past the last row)
__device__ __forceinline__ void stage(Smem& s, const float* __restrict__ src,
                                      int64_t row, bool live, int warp, int lane) {
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) v = *reinterpret_cast<const float4*>(src + (row * T + t) * D + lane * FPL);
    *reinterpret_cast<float4*>(&s.x[warp][t][lane * FPL]) = v;
  }
  __syncwarp();
}

template <bool CQ, bool CKV, bool MASK>
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_d3stn_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
                      const float* __restrict__ vs, const float* __restrict__ wq,
                      const float* __restrict__ bq, const float* __restrict__ wk,
                      const float* __restrict__ bk, const float* __restrict__ wv,
                      const float* __restrict__ bv, const float* __restrict__ wo,
                      const float* __restrict__ bo, float* __restrict__ out,
                      int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = row < rows;
  constexpr int PAD_SAME = (K - 1) / 2;

  float q[T][FPL], k[T][FPL];
  stage(s, mq, row, live, warp, lane);
  conv<CQ ? K - 1 : PAD_SAME>(s, wq, bq, warp, lane, q);
  stage(s, mk, row, live, warp, lane);
  conv<CKV ? K - 1 : PAD_SAME>(s, wk, bk, warp, lane, k);

  // scores of this lane's head; lane keeps rows tq = qd, qd + 4, qd + 8
  const int head = lane >> 2;
  const int qd = lane & 3;
  const float scale = 1.f / sqrtf((float)DH);
  float rowv[T / 4][T];
#pragma unroll
  for (int tq = 0; tq < T; ++tq) {
#pragma unroll
    for (int tk = 0; tk < T; ++tk) {
      float d = q[tq][0] * k[tk][0];
      d = fmaf(q[tq][1], k[tk][1], d);
      d = fmaf(q[tq][2], k[tk][2], d);
      d = fmaf(q[tq][3], k[tk][3], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d *= scale;
      if (MASK && tk > tq) d += -FLT_MAX;
      if ((tq & 3) == qd) rowv[tq >> 2][tk] = d;
    }
  }
#pragma unroll
  for (int i = 0; i < T / 4; ++i) {
    float mx = rowv[i][0];
#pragma unroll
    for (int tk = 1; tk < T; ++tk) mx = fmaxf(mx, rowv[i][tk]);
    float sum = 0.f;
#pragma unroll
    for (int tk = 0; tk < T; ++tk) {
      rowv[i][tk] = expf(rowv[i][tk] - mx);
      sum += rowv[i][tk];
    }
    float* prow = &s.p[warp][head][qd + 4 * i][0];
#pragma unroll
    for (int tk = 0; tk < T; tk += 4)
      *reinterpret_cast<float4*>(prow + tk) =
          make_float4(rowv[i][tk] / sum, rowv[i][tk + 1] / sum,
                      rowv[i][tk + 2] / sum, rowv[i][tk + 3] / sum);
  }

  float v[T][FPL];
  stage(s, vs, row, live, warp, lane);  // also publishes s.p within the warp
  conv<CKV ? K - 1 : PAD_SAME>(s, wv, bv, warp, lane, v);

  // (P V)[tq] for this lane's 4 features, written back as the out conv input
  __syncwarp();
#pragma unroll
  for (int tq = 0; tq < T; ++tq) {
    const float* prow = &s.p[warp][head][tq][0];
    float o[FPL] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int tk = 0; tk < T; tk += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(prow + tk);
      const float pk[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < FPL; ++e) o[e] = fmaf(pk[u], v[tk + u][e], o[e]);
    }
    *reinterpret_cast<float4*>(&s.x[warp][tq][lane * FPL]) = make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncwarp();

  float y[T][FPL];
  conv<PAD_SAME>(s, wo, bo, warp, lane, y);
  if (live) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      *reinterpret_cast<float4*>(out + (row * T + t) * D + lane * FPL) =
          make_float4(y[t][0], y[t][1], y[t][2], y[t][3]);
  }
}

template <bool CQ, bool CKV, bool MASK>
int launch(const void* const* p, void* out, int64_t rows, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_d3stn_kernel<CQ, CKV, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + WARPS - 1) / WARPS;
  attn_fwd_d3stn_kernel<CQ, CKV, MASK><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (const float*)p[9], (const float*)p[10], (float*)out, rows);
  return (int)cudaGetLastError();
}

// The three flag sets D3STN runs: encoder self-attention, decoder masked
// self-attention, decoder source attention. Other sets take the generic kernel.
bool covers(int tq, int tk, int d, int heads, int ks, int causal_q, int causal_kv,
            int is_mask) {
  if (tq != T || tk != T || d != D || heads != H || ks != K) return false;
  return (!causal_q && !causal_kv && !is_mask) || (causal_q && causal_kv && is_mask) ||
         (causal_q && !causal_kv && !is_mask);
}

int dispatch(const void* const* p, void* out, int64_t rows, int causal_q, int causal_kv,
             cudaStream_t stream) {
  if (!causal_q) return launch<false, false, false>(p, out, rows, stream);
  if (causal_kv) return launch<true, true, true>(p, out, rows, stream);
  return launch<true, false, false>(p, out, rows, stream);
}

}  // namespace fast

extern "C" int pxt_attn_fwd_smem_bytes(int tq, int tk, int d, int heads) {
  return (kNodes * (tq + 2 * tk) * d + kNodes * heads * tq * tk) *
         (int)sizeof(float);
}

// p: the 11 input pointers mq, mk, vs, wq, bq, wk, bk, wv, bv, wo, bo.
extern "C" int pxt_attn_fwd_f32(const void* const* p, void* out, int64_t rows,
                                int tq, int tk, int d, int heads, int ks,
                                int causal_q, int causal_kv, int is_mask,
                                void* stream) {
  if (d % 32 != 0 || d > 1024 || d % heads != 0 || tq > 16 || tk > 16 ||
      (is_mask && tq != tk))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (fast::covers(tq, tk, d, heads, ks, causal_q, causal_kv, is_mask))
    return fast::dispatch(p, out, rows, causal_q, causal_kv, s);
  const int smem = pxt_attn_fwd_smem_bytes(tq, tk, d, heads);
  if (tq <= 12 && tk <= 12)
    return launch<12>(p, out, rows, tq, tk, d, heads, ks, causal_q, causal_kv,
                      is_mask, smem, s);
  return launch<16>(p, out, rows, tq, tk, d, heads, ks, causal_q, causal_kv,
                    is_mask, smem, s);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
