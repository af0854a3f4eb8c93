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
// The TPU kernel's blockdiag/selector middle, [T, C] layout and VMEM tile
// caps are Mosaic workarounds and are not carried over.
//
// Dropout form (the TPU _fwd_kernel with has_dropout=True, reached through
// fused_temporal_attention_dropout): a float32 keep mask m [rows, T, H*T],
// pre-scaled {0, 1/keep} and head-major, multiplies the row softmax, p m
// (the float32 product), before the value product. It is the DROP
// instantiation of attn_fwd_d3stn_kernel (entry pxt_attn_fwd_f32_dropout);
// the generic kernel has no dropout form.
//
// D3STN's shape (T = 12, D = 128, H = 8, K = 3; every configuration the
// repo ships at D = 128) and its three flag sets take attn_fwd_d3stn_kernel.
// Bound: operations. The four convs are 98% of its work (8 K D^2 T flops per
// row); they run on the tensor cores in 3xTF32 through tc_conv.cuh (wgmma
// m64n128k8, float32 accuracy), the attention core on the CUDA cores.
//   - attn_fwd_wsplit_kernel splits the four weight banks into {big, small}
//     TF32 halves once per call, in the order the tensor cores read them
//     (scratch from the caller).
//   - attn_fwd_d3stn_kernel: one CTA of two warpgroups per 8 (batch, node)
//     rows (96 positions; half of the second warpgroup's m64 tile is
//     padding, since 16-row tiles would not fit q, k, P and the weight
//     stages in shared memory). mq and mk are staged in two shared tiles
//     (cp.async); the q and k
//     convs run in place; the scores, scale, mask and row softmax of each
//     (row, head, query step) go to a shared [8, H, T, T] buffer; vs is
//     staged over q, its conv runs in place and is replaced by P v column by
//     column; the out conv writes y. Nothing but the inputs, y and the split
//     banks touches device memory. 183 KB of shared memory: one CTA per SM.
//     The convs read the next weight chunk's A fragments while the tensor
//     cores run the current one (tc::conv at 256 threads).
//
// Other shapes take the generic attn_fwd_kernel: one CTA per kNodes rows,
// one thread per output feature (blockDim = D), the rows' inputs staged in
// shared memory, each conv's kNodes x T outputs of a feature in registers
// and W read from global memory (L2-resident); bound by operations in
// float32 on the CUDA cores.

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_conv.cuh"

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
// ships) and D3STN's three flag sets. See the head of this file.
// ---------------------------------------------------------------------------

namespace fast {

constexpr int T = tc::T, D = 128, H = 8, K = tc::K;
constexpr int DH = D / H;  // 16 features per head
constexpr int ROWS = 8;  // rows per CTA: 96 positions, two warpgroups
using G = tc::Geo<D, ROWS>;
constexpr int64_t BANK = tc::Bank<D>::SIZE;

struct Smem {
  float a[G::TILE];                 // mq -> q, then vs -> v -> P v
  float b[G::TILE];                 // mk -> k
  float w[tc::Bank<D>::STAGES];     // weight stages
  float p[ROWS][H][T][T];           // softmax rows
};

// the four [K, D, D] banks -> split banks (tc::bank_index order)
__global__ void attn_fwd_wsplit_kernel(const float* __restrict__ wq, const float* __restrict__ wk,
                                       const float* __restrict__ wv, const float* __restrict__ wo,
                                       float* __restrict__ ws) {
  constexpr int64_t W = (int64_t)K * D * D;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * W) return;
  const int i = (int)(idx / W);
  const int r = (int)(idx - i * W);
  const float* w = i == 0 ? wq : i == 1 ? wk : i == 2 ? wv : wo;
  tc::put_split<D>(ws + i * BANK, r / (D * D), (r / D) % D, r % D, w[r]);
}

// scores of the tile's q (s.a) and k (s.b) per (row, head, query step),
// scaled and masked, and their row softmax -> s.p; with DROP times the keep
// mask's row of (row, query step, head), dm[row][i][h T + j]
template <bool MASK, bool DROP>
__device__ __forceinline__ void softmax_rows(Smem& s, const float* __restrict__ dm,
                                             int64_t row0, int n_rows) {
  const float scale = 1.f / sqrtf((float)DH);
  for (int item = threadIdx.x; item < ROWS * H * T; item += G::THREADS) {
    const int i = item % T;
    const int h = (item / T) % H;
    const int r = item / (T * H);
    float q[DH];
    const float* qrow = s.a + (r * T + i) * G::S + h * DH;
#pragma unroll
    for (int e = 0; e < DH; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(qrow + e);
      q[e] = v.x; q[e + 1] = v.y; q[e + 2] = v.z; q[e + 3] = v.w;
    }
    float row[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float* krow = s.b + (r * T + j) * G::S + h * DH;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < DH; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(krow + e);
        d = fmaf(q[e], v.x, d);
        d = fmaf(q[e + 1], v.y, d);
        d = fmaf(q[e + 2], v.z, d);
        d = fmaf(q[e + 3], v.w, d);
      }
      d *= scale;
      if (MASK && j > i) d += -FLT_MAX;
      row[j] = d;
    }
    float mx = row[0];
#pragma unroll
    for (int j = 1; j < T; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      row[j] = expf(row[j] - mx);
      sum += row[j];
    }
    float* prow = &s.p[r][h][i][0];
#pragma unroll
    for (int j = 0; j < T; j += 4) {
      float4 p = make_float4(row[j] / sum, row[j + 1] / sum, row[j + 2] / sum, row[j + 3] / sum);
      if (DROP) {
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < n_rows)
          m = __ldg(reinterpret_cast<const float4*>(dm + ((row0 + r) * T + i) * (H * T) + h * T + j));
        p = make_float4(p.x * m.x, p.y * m.y, p.z * m.z, p.w * m.w);
      }
      *reinterpret_cast<float4*>(prow + j) = p;
    }
  }
}

// s.a (v) <- P v, one (row, feature) column per step: a column reads and
// writes only itself, so the update is in place
__device__ __forceinline__ void apply_p(Smem& s) {
  for (int col = threadIdx.x; col < ROWS * D; col += G::THREADS) {
    const int f = col % D;
    const int r = col / D;
    float v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = s.a[(r * T + j) * G::S + f];
    const float* pr = &s.p[r][f / DH][0][0];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) o = fmaf(pr[i * T + j], v[j], o);
      s.a[(r * T + i) * G::S + f] = o;
    }
  }
}

template <bool CQ, bool CKV, bool MASK, bool DROP>
__global__ void __launch_bounds__(G::THREADS, 1)
attn_fwd_d3stn_kernel(const float* __restrict__ mq, const float* __restrict__ mk,
                      const float* __restrict__ vs, const float* __restrict__ ws,
                      const float* __restrict__ bq, const float* __restrict__ bk,
                      const float* __restrict__ bv, const float* __restrict__ bo,
                      const float* __restrict__ dm, float* __restrict__ out, int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int PAD_SAME = (K - 1) / 2;
  constexpr int PQ = CQ ? K - 1 : PAD_SAME;
  constexpr int PKV = CKV ? K - 1 : PAD_SAME;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int n_rows = (int)min((int64_t)ROWS, rows - row0);
  tc::Acc<D> acc;

  tc::stage<D, ROWS>(s.a, mq, row0, n_rows);
  tc::stage<D, ROWS>(s.b, mk, row0, n_rows);
  __syncthreads();
  tc::conv<D, ROWS>(s.a, ws, s.w, PQ, acc);
  tc::store_tile<D, ROWS>(s.a, acc, bq);
  tc::conv<D, ROWS>(s.b, ws + BANK, s.w, PKV, acc);
  tc::store_tile<D, ROWS>(s.b, acc, bk);
  __syncthreads();
  softmax_rows<MASK, DROP>(s, dm, row0, n_rows);
  __syncthreads();
  tc::stage<D, ROWS>(s.a, vs, row0, n_rows);
  __syncthreads();
  tc::conv<D, ROWS>(s.a, ws + 2 * BANK, s.w, PKV, acc);
  tc::store_tile<D, ROWS>(s.a, acc, bv);
  __syncthreads();
  apply_p(s);
  __syncthreads();
  tc::conv<D, ROWS>(s.a, ws + 3 * BANK, s.w, PAD_SAME, acc);
  tc::store_global<D, ROWS>(out, row0, n_rows, acc, bo);
}

template <bool CQ, bool CKV, bool MASK, bool DROP>
int launch(const void* const* p, const float* dm, void* out, float* ws, int64_t rows,
           cudaStream_t stream) {
  constexpr int64_t W = (int64_t)K * D * D;
  attn_fwd_wsplit_kernel<<<(unsigned)((4 * W + 255) / 256), 256, 0, stream>>>(
      (const float*)p[3], (const float*)p[5], (const float*)p[7], (const float*)p[9], ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(attn_fwd_d3stn_kernel<CQ, CKV, MASK, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + ROWS - 1) / ROWS;
  attn_fwd_d3stn_kernel<CQ, CKV, MASK, DROP><<<(unsigned)blocks, G::THREADS, smem, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2], ws, (const float*)p[4],
      (const float*)p[6], (const float*)p[8], (const float*)p[10], dm, (float*)out, rows);
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

template <bool DROP>
int dispatch(const void* const* p, const float* dm, void* out, float* ws, int64_t rows,
             int causal_q, int causal_kv, cudaStream_t stream) {
  if (!causal_q) return launch<false, false, false, DROP>(p, dm, out, ws, rows, stream);
  if (causal_kv) return launch<true, true, true, DROP>(p, dm, out, ws, rows, stream);
  return launch<true, false, false, DROP>(p, dm, out, ws, rows, stream);
}

}  // namespace fast

extern "C" int pxt_attn_fwd_smem_bytes(int tq, int tk, int d, int heads) {
  return (kNodes * (tq + 2 * tk) * d + kNodes * heads * tq * tk) *
         (int)sizeof(float);
}

// floats of scratch the call needs: the split weight banks of the D3STN
// kernel, 0 for the generic one
extern "C" int64_t pxt_attn_fwd_scratch_floats(int tq, int tk, int d, int heads, int ks,
                                               int causal_q, int causal_kv, int is_mask) {
  if (!fast::covers(tq, tk, d, heads, ks, causal_q, causal_kv, is_mask)) return 0;
  return 8 * (int64_t)ks * d * d;
}

// p: the 11 input pointers mq, mk, vs, wq, bq, wk, bk, wv, bv, wo, bo;
// scratch: pxt_attn_fwd_scratch_floats(...) floats (16-byte aligned).
extern "C" int pxt_attn_fwd_f32(const void* const* p, void* out, void* scratch, int64_t rows,
                                int tq, int tk, int d, int heads, int ks,
                                int causal_q, int causal_kv, int is_mask,
                                void* stream) {
  if (d % 32 != 0 || d > 1024 || d % heads != 0 || tq > 16 || tk > 16 ||
      (is_mask && tq != tk))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (fast::covers(tq, tk, d, heads, ks, causal_q, causal_kv, is_mask))
    return fast::dispatch<false>(p, nullptr, out, (float*)scratch, rows, causal_q, causal_kv, s);
  const int smem = pxt_attn_fwd_smem_bytes(tq, tk, d, heads);
  if (tq <= 12 && tk <= 12)
    return launch<12>(p, out, rows, tq, tk, d, heads, ks, causal_q, causal_kv,
                      is_mask, smem, s);
  return launch<16>(p, out, rows, tq, tk, d, heads, ks, causal_q, causal_kv,
                    is_mask, smem, s);
}

// the dropout form at D3STN's shape only; dmask: float32 [rows, 12, 8 * 12]
extern "C" int pxt_attn_fwd_f32_dropout(const void* const* p, const void* dmask, void* out,
                                        void* scratch, int64_t rows, int tq, int tk, int d,
                                        int heads, int ks, int causal_q, int causal_kv,
                                        int is_mask, void* stream) {
  if (!fast::covers(tq, tk, d, heads, ks, causal_q, causal_kv, is_mask))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  return fast::dispatch<true>(p, (const float*)dmask, out, (float*)scratch, rows, causal_q,
                              causal_kv, (cudaStream_t)stream);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
