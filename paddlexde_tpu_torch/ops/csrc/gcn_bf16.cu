// Fused spatial-attention GCN mixing (forward) in bfloat16, for Hopper
// (sm_90a).
//
// Replaces the bfloat16 form (dtype_name="bfloat16") of the Pallas TPU kernel
// paddlexde_tpu/ops/gcn_pallas.py (_fwd_kernel, launched by _pallas_fwd for
// gcn_spatial_mix). For every (batch b, time t) slice X = x[b, :, t, :] of
// shape [N, D] it keeps the TPU kernel's rounding points:
//
//   s = X X^T * scale1                   float32
//   p = softmax_rows(s) * scale2         float32
//   a = bf16(bf16(p) * bf16(gate))
//   y = bf16(a @ bf16(X))                float32 sums
//
// x is float32 (what D3STN passes) or bfloat16; y is bfloat16. D = 64 and
// 128. One CTA of one warpgroup (128 threads) takes a work item: 64 rows n
// of one slice, staged in shared memory as they are. The nodes m stream
// through shared memory in tiles of 64. The scores of a tile are wgmma
// m64n64: for a float32 x in 3xTF32 with gcn_tc.cuh's score_tile, B split
// into K-major TF32 core matrices; for a bfloat16 x one bfloat16 product,
// exact, B the tile as it is in K-major core matrices. A row's bf16(p) needs
// its final maximum and sum, so one online pass cannot round where the TPU
// kernel does:
//
// - N <= 192 (every shipped configuration up to PEMS08): the scores of all
//   (at most 3) tiles stay in registers; the row maximum, the exponentials
//   and their sum follow as the TPU kernel's softmax takes them;
// - larger N: two passes over the tiles, the first for each row's running
//   maximum and sum of exp, the second takes the scores again.
//
// Then p and a, held in the score accumulator's layout, are the A fragment
// of the mix: wgmma m64nDk16 in bfloat16 against the node tile in bfloat16,
// K-major over the nodes, written by the CUDA cores over the scores' B
// tile. Each tile's 4 k-steps start a fresh accumulator, added to the
// float32 output on the CUDA cores (tc_bf16.cuh).
//
// Bound: operations (4 N^2 D per slice on the tensor cores, in 3xTF32 for the
// scores of a float32 x, and ~5 N^2 on the CUDA cores) against N D elements
// read and written. Past N = 192 the scores run twice: 6 N^2 D products
// where the TPU kernel does 4. Shared memory: 97 KB at D = 128 for a float32
// x, two CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gcn_tc.cuh"
#include "tc_bf16.cuh"

namespace {

constexpr int NT = gcn_tc::NT;  // nodes per tile, rows per item
constexpr int THREADS = 128;    // one warpgroup
constexpr int CH16 = 4;         // bfloat16 k-steps per score chain (64 products)

template <int D, bool XB>
struct Smem;

// float32 x
template <int D>
struct Smem<D, false> {
  float xn[NT][D + 4];  // the item's rows, as they are: A of the scores
  union {
    float split[D / 8][2][gcn_tc::TILE];  // the node tile split: B of the scores
    uint16_t mix[NT / 16][D * 16];        // the node tile in bfloat16: B of the mix
  } b;
};

// bfloat16 x
template <int D>
struct Smem<D, true> {
  uint16_t xn[NT][D + 8];  // the item's rows: A of the scores
  union {
    uint16_t score[D / 16][NT * 16];  // the node tile, K-major over the features
    uint16_t mix[NT / 16][D * 16];    // the node tile, K-major over the nodes
  } b;
};

// rows r0 .. r0 + NT - 1 of a slice -> dst as they are (cp.async, zeros
// past n; committed)
template <int D, typename T, int S>
__device__ __forceinline__ void stage_rows(T (*dst)[S], const T* __restrict__ src, int r0, int n,
                                           int64_t stride) {
  constexpr int V = 16 / sizeof(T);
  for (int u = threadIdx.x; u < NT * (D / V); u += THREADS) {
    const int r = u / (D / V);
    const int q = u % (D / V);
    const bool full = r0 + r < n;
    tc::cp_async16_zfill(&dst[r][V * q], src + (full ? (int64_t)(r0 + r) * stride + V * q : 0),
                         full);
  }
  tc::cp_async_commit();
}

// float32 node tile m0 .. m0 + NT - 1 -> split TF32 tile (gcn_tc.cuh's
// layout: k-block f / 8, tc::b_offset(node, f % 8)); a quarter warp takes
// 8 nodes of one float4 column, so its 16-byte stores hit distinct banks
template <int D>
__device__ __forceinline__ void stage_split(float (*dst)[2][gcn_tc::TILE],
                                            const float* __restrict__ src, int m0, int n,
                                            int64_t stride) {
  constexpr int ITER = NT * (D / 4) / THREADS;
#pragma unroll 4
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = (u >> 3) / (D / 4) * 8 + (u & 7);
    const int q = (u >> 3) % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < n)
      v = __ldg(reinterpret_cast<const float4*>(src + (int64_t)(m0 + r) * stride + 4 * q));
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    tc::split_tf32(v.x, b0, s0);
    tc::split_tf32(v.y, b1, s1);
    tc::split_tf32(v.z, b2, s2);
    tc::split_tf32(v.w, b3, s3);
    const int off = tc::b_offset(r, (4 * q) % 8);
    *reinterpret_cast<uint4*>(&dst[q / 2][0][off]) = make_uint4(b0, b1, b2, b3);
    *reinterpret_cast<uint4*>(&dst[q / 2][1][off]) = make_uint4(s0, s1, s2, s3);
  }
}

// bfloat16 node tile -> B of the scores: K-major over the features (k-block
// f / 16, tc16::b_offset(node, f % 16)), 16-byte rows of 8 features
template <int D>
__device__ __forceinline__ void stage_score16(uint16_t (*dst)[NT * 16],
                                              const uint16_t* __restrict__ src, int m0, int n,
                                              int64_t stride) {
  constexpr int ITER = NT * (D / 8) / THREADS;
#pragma unroll 4
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = (u >> 3) / (D / 8) * 8 + (u & 7);
    const int q = (u >> 3) % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(m0 + r) * stride + 8 * q));
    *reinterpret_cast<uint4*>(&dst[q / 2][tc16::b_offset(r, (8 * q) % 16)]) = v;
  }
}

__device__ __forceinline__ float load_as_float(const float* __restrict__ p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const uint16_t* __restrict__ p) {
  return tc16::from_bf16(__ldg(p));
}

// node tile -> B of the mix in bfloat16: K-major over the nodes (k-block
// m / 16, tc16::b_offset(feature, m % 16)); a thread writes the 16-byte row
// of one feature and 8 nodes, a warp's loads of a node are 32 consecutive
// features
template <int D, typename T>
__device__ __forceinline__ void stage_mix(uint16_t (*dst)[D * 16], const T* __restrict__ src,
                                          int m0, int n, int64_t stride) {
  constexpr int ITER = (NT / 8) * D / THREADS;
#pragma unroll 2
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int f = u % D;
    const int c = u / D;  // nodes 8 c .. 8 c + 7 of the tile
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = m0 + 8 * c + 2 * k;
      const float lo = m < n ? load_as_float(src + (int64_t)m * stride + f) : 0.f;
      const float hi = m + 1 < n ? load_as_float(src + (int64_t)(m + 1) * stride + f) : 0.f;
      w[k] = tc16::pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(&dst[c / 2][tc16::b_offset(f, (8 * c) % 16)]) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// acc[n, m] = sum_f a[n][f] xs[m][f] for the warpgroup's 64 rows of a and
// the 64 nodes of the tile, bfloat16 products (exact) in chains of CH16
// k-steps added in float32; acc in the m64n64 fragment
template <int D>
__device__ __forceinline__ void score16(const uint16_t (*a)[D + 8], const uint16_t (*xs)[NT * 16],
                                        float (&acc)[32]) {
  constexpr int KS = D / 16;
  const int r = gcn_tc::wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += CH16) {
    uint32_t af[CH16][4];
#pragma unroll
    for (int j = 0; j < CH16; ++j) {
      const int c = (k0 + j) * 16 + 2 * tq;
      af[j][0] = *reinterpret_cast<const uint32_t*>(&a[r][c]);
      af[j][1] = *reinterpret_cast<const uint32_t*>(&a[r + 8][c]);
      af[j][2] = *reinterpret_cast<const uint32_t*>(&a[r][c + 8]);
      af[j][3] = *reinterpret_cast<const uint32_t*>(&a[r + 8][c + 8]);
    }
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < CH16; ++j)
      tc16::wgmma_n64(part, af[j], tc::desc_b(reinterpret_cast<const float*>(xs[k0 + j])), j > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < CH16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::hold(af[j][i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      tc::hold(part[i]);
      acc[i] += part[i];
    }
  }
}

// the scores of node tile m0 for the item's rows: staged B, then the product
template <int D, bool XB, typename T>
__device__ __forceinline__ void tile_scores(Smem<D, XB>& s, const T* __restrict__ xs, int m0,
                                            int n, int64_t stride, float (&acc)[32]) {
  if constexpr (XB)
    stage_score16<D>(s.b.score, xs, m0, n, stride);
  else
    stage_split<D>(s.b.split, xs, m0, n, stride);
  tc::cp_async_wait_all();  // the item's rows (first tile)
  tc::fence_proxy_async();
  __syncthreads();
  if constexpr (XB)
    score16<D>(s.xn, s.b.score, acc);
  else
    gcn_tc::score_tile<D>(s.xn, s.b.split, acc);
  __syncthreads();  // the B tile is free again
}

// the A fragments of the mix for node tile m0: a = bf16(bf16(p) bf16(gate))
// with p = e / sum * scale2, e in the m64n64 fragment (0 past n)
__device__ __forceinline__ void mix_operand(const float (&e)[32], const float (&sum)[2],
                                            float scale2, const float* const (&grow)[2], int m0,
                                            int n, uint32_t (&af)[NT / 16][4]) {
  const int tq = threadIdx.x & 3;
  const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int col = m0 + 8 * nb + 2 * tq + k;
        const float p = tc16::div_rn(e[4 * nb + 2 * h + k], sum[h], rsum[h]) * scale2;
        const float g = __ldg(grow[h] + min(col, n - 1));
        a[k] = tc16::round_bf16(tc16::round_bf16(p) * tc16::round_bf16(g));
      }
      af[nb / 2][(nb % 2) * 2 + h] = tc16::pack_bf16(a[0], a[1]);
    }
}

// out += a @ bf16(X) over node tile m0: the tile staged as B of the mix
// (over the scores' B tile, which the caller is done with), one fresh
// accumulator for its 4 k-steps
template <int D, bool XB, typename T>
__device__ __forceinline__ void mix_tile(Smem<D, XB>& s, const T* __restrict__ xs, int m0, int n,
                                         int64_t stride, uint32_t (&af)[NT / 16][4],
                                         float (&out)[D / 2]) {
  stage_mix<D>(s.b.mix, xs, m0, n, stride);
  tc::fence_proxy_async();
  __syncthreads();
  float part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
    tc16::wgmma<D>(part, af[j], tc::desc_b(reinterpret_cast<const float*>(s.b.mix[j])), j > 0);
  tc::wgmma_commit();
  tc::wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NT / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tc::hold(af[j][i]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    tc::hold(part[i]);
    out[i] += part[i];
  }
  __syncthreads();  // the B tile is free again
}

// TILES > 0 (N <= 64 TILES): every score of the item stays in registers, one
// pass. TILES == 0: any N, two passes (the scores taken twice).
template <int D, bool XB, int TILES>
__global__ void __launch_bounds__(THREADS)
gcn_bf16_fwd_kernel(const void* __restrict__ xv, const float* __restrict__ gate,
                    uint16_t* __restrict__ y, int n, int t_len, float scale1, float scale2) {
  using T = std::conditional_t<XB, uint16_t, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D, XB>& s = *reinterpret_cast<Smem<D, XB>*>(smem_raw);
  const int tiles = (n + NT - 1) / NT;
  const int n0 = (blockIdx.x % tiles) * NT;
  const int bt = blockIdx.x / tiles;  // b * t_len + t
  const int64_t stride = (int64_t)t_len * D;
  const int64_t off = ((int64_t)(bt / t_len) * n * t_len + bt % t_len) * D;
  const T* xs = reinterpret_cast<const T*>(xv) + off;
  const int r = gcn_tc::wg_row();
  const int tq = threadIdx.x & 3;
  const float* const grow[2] = {gate + (int64_t)min(n0 + r, n - 1) * n,
                                gate + (int64_t)min(n0 + r + 8, n - 1) * n};
  // a column of the m64n64 fragment: acc[4 nb + 2 h + k] is (row r + 8 h,
  // column 8 nb + 2 tq + k) of the tile
  auto col_of = [&](int m0, int i) { return m0 + 8 * (i / 4) + 2 * tq + i % 2; };

  stage_rows<D>(s.xn, xs, n0, n, stride);
  float out[D / 2];  // Y [row, feature] in the m64nD fragment

  if constexpr (TILES > 0) {
    // the scaled scores of every node tile, then each row's maximum, the
    // exponentials and their sum, as the TPU kernel's softmax takes them
    float e[TILES][32];
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      tile_scores<D, XB>(s, xs, t * NT, n, stride, e[t]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        e[t][i] *= scale1;
        if (col_of(t * NT, i) < n) row_max[(i / 2) % 2] = fmaxf(row_max[(i / 2) % 2], e[t][i]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) row_max[h] = gcn_tc::quad_max(row_max[h]);
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        e[t][i] = col_of(t * NT, i) < n ? expf(e[t][i] - row_max[(i / 2) % 2]) : 0.f;
        row_sum[(i / 2) % 2] += e[t][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) row_sum[h] = gcn_tc::quad_sum(row_sum[h]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) out[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      uint32_t af[NT / 16][4];
      mix_operand(e[t], row_sum, scale2, grow, t * NT, n, af);
      mix_tile<D, XB>(s, xs, t * NT, n, stride, af, out);
    }
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) out[i] = 0.f;
    // pass 1: each row's maximum and sum of exp over all nodes (online)
    float acc[32];
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    for (int m0 = 0; m0 < n; m0 += NT) {
      tile_scores<D, XB>(s, xs, m0, n, stride, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i / 2) % 2 == h && col_of(m0, i) < n) tmax = fmaxf(tmax, acc[i] * scale1);
        const float new_max = fmaxf(row_max[h], gcn_tc::quad_max(tmax));
        float tsum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i / 2) % 2 == h && col_of(m0, i) < n) tsum += expf(acc[i] * scale1 - new_max);
        row_sum[h] = row_sum[h] * expf(row_max[h] - new_max) + gcn_tc::quad_sum(tsum);
        row_max[h] = new_max;
      }
    }
    // pass 2: the scores again, p, a and the mix
    for (int m0 = 0; m0 < n; m0 += NT) {
      tile_scores<D, XB>(s, xs, m0, n, stride, acc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = col_of(m0, i) < n ? expf(acc[i] * scale1 - row_max[(i / 2) % 2]) : 0.f;
      uint32_t af[NT / 16][4];
      mix_operand(acc, row_sum, scale2, grow, m0, n, af);
      mix_tile<D, XB>(s, xs, m0, n, stride, af, out);
    }
  }

  // y = bf16(out); a warp's store covers 8 rows x 8 features per nb
  uint16_t* yb = y + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + r + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(yb + (int64_t)row * stride + 8 * nb + 2 * tq) =
          tc16::pack_bf16(out[4 * nb + 2 * h], out[4 * nb + 2 * h + 1]);
  }
}

template <int D, bool XB, int TILES>
int launch(const void* x, const float* gate, uint16_t* y, int b, int n, int t_len, float scale1,
           float scale2, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D, XB>);
  cudaError_t err = cudaFuncSetAttribute(gcn_bf16_fwd_kernel<D, XB, TILES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t items = (int64_t)((n + NT - 1) / NT) * t_len * b;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  gcn_bf16_fwd_kernel<D, XB, TILES><<<(unsigned)items, THREADS, smem, stream>>>(
      x, gate, y, n, t_len, scale1, scale2);
  return (int)cudaGetLastError();
}

// up to 3 node tiles (N <= 192: every shipped configuration up to PEMS08)
// the scores stay in registers
template <int D, bool XB>
int dispatch(const void* x, const float* gate, uint16_t* y, int b, int n, int t_len,
             float scale1, float scale2, cudaStream_t stream) {
  switch ((n + NT - 1) / NT) {
    case 1: return launch<D, XB, 1>(x, gate, y, b, n, t_len, scale1, scale2, stream);
    case 2: return launch<D, XB, 2>(x, gate, y, b, n, t_len, scale1, scale2, stream);
    case 3: return launch<D, XB, 3>(x, gate, y, b, n, t_len, scale1, scale2, stream);
    default: return launch<D, XB, 0>(x, gate, y, b, n, t_len, scale1, scale2, stream);
  }
}

}  // namespace

// x [b, n, t_len, d] float32 (x_bf16 = 0) or bfloat16 (1), gate [n, n]
// float32, y [b, n, t_len, d] bfloat16; d = 64 or 128
extern "C" int pxt_gcn_fwd_bf16(const void* x, const void* gate, void* y, int b, int n, int t_len,
                                int d, int x_bf16, float scale1, float scale2, void* stream) {
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if ((int64_t)b * n * t_len == 0) return 0;
  const float* g = (const float*)gate;
  uint16_t* yb = (uint16_t*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return x_bf16 ? dispatch<128, true>(x, g, yb, b, n, t_len, scale1, scale2, s)
                  : dispatch<128, false>(x, g, yb, b, n, t_len, scale1, scale2, s);
  return x_bf16 ? dispatch<64, true>(x, g, yb, b, n, t_len, scale1, scale2, s)
                : dispatch<64, false>(x, g, yb, b, n, t_len, scale1, scale2, s);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
