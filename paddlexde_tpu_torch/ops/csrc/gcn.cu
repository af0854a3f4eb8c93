// Fused spatial-attention GCN mixing (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/gcn_pallas.py
// (_fwd_kernel, launched by _pallas_fwd for gcn_spatial_mix). For every
// (batch b, time t) slice X = x[b, :, t, :] of shape [N, D]:
//
//   y[b, n, t, :] = sum_m softmax_m(X[n] . X[m] * scale1) * scale2
//                   * gate[n, m] * X[m]
//
// D = 64 and D = 128 (every configuration the repo ships):
// gcn_fwd_tc_kernel runs both N^2 D products on the tensor cores in 3xTF32
// with the pieces of gcn_tc.cuh, for any N. One persistent CTA per SM (two
// warpgroups, 256 threads) walks the work items (64 rows n, t, b); the
// nodes m stream through shared memory in tiles of 64. Per tile:
//
// 1. the next node tile (this item's next, else the next item's first) is
//    copied in as it is (cp.async) into the second raw buffer;
// 2. the scores S = X_n X_m^T as wgmma m64n64k8 (A the item's rows, split
//    as they are read; B the node tile, split into K-major core matrices).
//    Warpgroup w takes the features of half the k-steps (one chain of
//    D / 16), and the two halves add in float32 as they are exchanged;
// 3. the row softmax online (running max and sum, in base 2: the scores
//    scaled by scale1 log2(e), then exp2) on the CUDA cores, each warpgroup
//    for half of the rows; e gate goes split into shared memory as the B
//    operand of the mix;
// 4. the next tile is split into the split buffer, which the scores have
//    done with; then the mix Y^T = X_m^T (e gate)^T with the features on M
//    (warpgroup w takes features 64 w .. 64 w + 63; at D = 64 warpgroup 0
//    alone), A read transposed from the raw tile and split as it is read:
//    one chain of 8 k-steps (24 products) added to the float32 output,
//    which the rescale by alpha joins.
//
// The next item's rows are copied in once this item's last scores are
// taken. y = scale2 / l * out is written once; the [N, N] block never
// reaches device memory. Bound: operations (4 N^2 D flops per slice, in
// 3xTF32 on the tensor cores, and 5 N^2 on the CUDA cores) against 2 N D
// floats moved. Shared memory (213.5 KB at D = 128) holds one CTA per SM.
//
// Other widths (D a multiple of 32 up to 256) take gcn_fwd_kernel on the
// CUDA cores: one CTA per (row tile of 32 nodes, t, b), 8 warps of 4 rows
// each. The whole X slice is staged once into shared memory (N x (D+1)
// floats), so it raises past 227 KB. The row stride D+1 keeps the score
// loop (lane = node m, running over D) free of bank conflicts. Each warp
// computes its 4 score rows into a per-warp shared buffer, takes the row
// softmax with warp shuffles, folds scale2 and the gate row in, then
// multiplies by X with lane = feature.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gcn_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kMaxDk = 8;  // D / 32 <= 8, i.e. D <= 256

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
gcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gate,
               float* __restrict__ y, int n, int t_len, int d, float scale1,
               float scale2) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sx = smem;              // [n][ld]
  float* sp = smem + n * ld;     // [kRowsPerCta][n]
  const int t = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t node_stride = (int64_t)t_len * d;
  const float* xbt = x + (b * n * t_len + t) * (int64_t)d;  // x[b, 0, t, 0]

  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int m = e / d;
    const int c = e - m * d;
    sx[m * ld + c] = xbt[m * node_stride + c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  if (row0 >= n) return;  // whole warp idle; no CTA-wide barrier follows
  int rows[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) rows[r] = min(row0 + r, n - 1);
  float* p = sp + warp * kRowsPerWarp * n;

  // scores: lane owns nodes m = lane, lane + 32, ...
  for (int m = lane; m < n; m += 32) {
    float acc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
    const float* xm = sx + m * ld;
    for (int c = 0; c < d; ++c) {
      const float v = xm[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        acc[r] = fmaf(sx[rows[r] * ld + c], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) p[r * n + m] = acc[r] * scale1;
  }
  __syncwarp();

  // row softmax, then * scale2 * gate[row, m]
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* pr = p + r * n;
    float mx = -INFINITY;
    for (int m = lane; m < n; m += 32) mx = fmaxf(mx, pr[m]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int m = lane; m < n; m += 32) {
      const float e = expf(pr[m] - mx);
      pr[m] = e;
      s += e;
    }
    s = warp_sum(s);
    const float* grow = gate + (int64_t)rows[r] * n;
    for (int m = lane; m < n; m += 32) pr[m] = pr[m] / s * scale2 * grow[m];
  }
  __syncwarp();

  // y[row] = p[row] @ X: lane owns features c = lane + 32 k
  const int dk = d >> 5;
  float acc[kRowsPerWarp][kMaxDk];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int k = 0; k < kMaxDk; ++k) acc[r][k] = 0.f;
  for (int m = 0; m < n; ++m) {
    float xv[kMaxDk];
#pragma unroll
    for (int k = 0; k < kMaxDk; ++k) xv[k] = k < dk ? sx[m * ld + lane + 32 * k] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pr = p[r * n + m];
#pragma unroll
      for (int k = 0; k < kMaxDk; ++k) acc[r][k] = fmaf(pr, xv[k], acc[r][k]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (row0 + r >= n) break;
    float* yr = y + ((b * n + row0 + r) * t_len + t) * (int64_t)d;
#pragma unroll
    for (int k = 0; k < kMaxDk; ++k)
      if (k < dk) yr[lane + 32 * k] = acc[r][k];
  }
}

}  // namespace

namespace {

using namespace gcn_tc;

template <int D>
struct FwdSmem {
  float xn[NT][D + 4];          // the item's rows of x, as they are: A of the scores
  float xr[2][NT][D + 4];       // two node tiles of x, as they are: A of the mix;
                                // the next one copied in under this one
  float xm[D / 8][2][TILE];     // the node tile split (k = features): B of the scores
  float ew[NT / 8][2][TILE];    // e gate split, [k-block of m][big | small], N = n:
                                // B of the mix
  float ex[NT][EX];             // score halves of the rows the other warpgroup takes
  float alpha[NT];
  float yscale[NT];             // scale2 / l of each row
};

// a node tile as it is (raw, [NT][D + 4]) -> dst split, as stage_split
// writes it
template <int D>
__device__ __forceinline__ void split_raw(float (*dst)[2][TILE], const float (*raw)[D + 4]) {
  float4 v[SPLIT_ITER<D>];
#pragma unroll
  for (int i = 0; i < SPLIT_ITER<D>; ++i) {
    const int u = threadIdx.x + i * THREADS;
    v[i] = *reinterpret_cast<const float4*>(&raw[split_node<D>(u)][4 * split_quad<D>(u)]);
  }
  store_split<D>(dst, v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
gcn_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ gate,
                  float* __restrict__ y, int nb, int n, int t_len, float scale1, float scale2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<D>& s = *reinterpret_cast<FwdSmem<D>*>(smem_raw);
  constexpr int KS = D / 16;       // k-steps of a warpgroup's half of a score
  const int64_t node_stride = (int64_t)t_len * D;
  const int wg = threadIdx.x >> 7;
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
  const bool mixer = wg < D / 64;  // warpgroup w mixes features 64 w .. 64 w + 63
  const int fr = wg * 64 + r;      // its features fr and fr + 8
  const int rl = r + 8 * wg;       // the row of the thread's online softmax
  const int tiles = (n + NT - 1) / NT;
  const int items = tiles * t_len * nb;
  // the scores in base 2: exp(v scale1) = exp2(v scale1 log2(e))
  const float sl2 = scale1 * 1.44269504088896341f;
  // work item: (row block, t, b), row blocks fastest; x and y of item i
  // start at slice(i)
  auto slice = [&](int i) {
    const int bt = i / tiles;  // b * t_len + t
    return ((int64_t)(bt / t_len) * n * t_len + bt % t_len) * D;
  };
  if ((int)blockIdx.x >= items) return;

  stage_raw<D>(s.xn, x + slice(blockIdx.x), (blockIdx.x % tiles) * NT, n, node_stride);
  stage_raw<D>(s.xr[0], x + slice(blockIdx.x), 0, n, node_stride);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();
  split_raw<D>(s.xm, s.xr[0]);
  tc::fence_proxy_async();
  __syncthreads();

  // persistent: each CTA takes the items blockIdx.x + k gridDim.x
  int cur = 0;  // the raw buffer holding the current node tile
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item % tiles) * NT;
    const int64_t off = slice(item);
    const int next = item + gridDim.x;
    const float* xnext = next < items ? x + slice(next) : nullptr;
    const float* grow = gate + (int64_t)min(n0 + rl, n - 1) * n;
    float run_max = -INFINITY, run_sum = 0.f;
    float out[32];  // mixers: Y^T [feature, row] in the m64n64 fragment
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] = 0.f;

    for (int m0 = 0; m0 < n; m0 += NT) {
      const bool last = m0 + NT >= n;
      const bool next_rows = last && xnext != nullptr;
      const bool more = !last || xnext != nullptr;
      if (more) {  // the next node tile (this item's next, else the next item's first)
        stage_raw<D>(s.xr[cur ^ 1], last ? xnext : x + off, last ? 0 : m0 + NT, n, node_stride);
        tc::cp_async_commit();
      }
      float gt[16];  // the gate of the thread's row, loaded under the scores
#pragma unroll
      for (int i = 0; i < 16; ++i) gt[i] = grow[min(m0 + (i / 2) * 8 + 2 * tq + i % 2, n - 1)];

      float sc[32];  // warpgroup w: the score over the features of its k-steps
      score_tile<D, KS>(s.xn, s.xm, sc, wg * KS);
      swap_out(s.ex, sc, wg);
      __syncthreads();
      if (next_rows) {  // the rows are read: the next item's
        stage_raw<D>(s.xn, xnext, (next % tiles) * NT, n, node_stride);
        tc::cp_async_commit();
      }

      {
        float sv[16], dv[16];
        swap_in(s.ex, sc, wg, sv, dv);
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          sv[i] = (sv[i] + dv[i]) * sl2;
          if (m0 + (i / 2) * 8 + 2 * tq + i % 2 < n) tmax = fmaxf(tmax, sv[i]);
        }
        const float new_max = fmaxf(run_max, quad_max(tmax));
        const float alpha = exp2f(run_max - new_max);  // 0 on the first tile
        float tsum = 0.f;
#pragma unroll
        for (int nb8 = 0; nb8 < 8; ++nb8) {  // columns 8 nb8 + 2 tq + e, e = 0, 1
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * nb8 + e;
            const float ev = m0 + 8 * nb8 + 2 * tq + e < n ? exp2f(sv[i] - new_max) : 0.f;
            tsum += ev;
            w[e] = ev * gt[i];
          }
          uint32_t b0, s0, b1, s1;
          tc::split_tf32(w[0], b0, s0);
          tc::split_tf32(w[1], b1, s1);
          float* tile = &s.ew[nb8][0][tc::b_offset(rl, 2 * tq)];
          *reinterpret_cast<uint2*>(tile) = make_uint2(b0, b1);
          *reinterpret_cast<uint2*>(tile + TILE) = make_uint2(s0, s1);
        }
        run_sum = run_sum * alpha + quad_sum(tsum);
        run_max = new_max;
        if (tq == 0) {
          s.alpha[rl] = alpha;
          if (last) s.yscale[rl] = scale2 / run_sum;
        }
      }
      if (next_rows)  // the next node tile has landed; the next rows may not yet
        tc::cp_async_wait_prev();
      else
        tc::cp_async_wait_all();
      tc::fence_proxy_async();
      __syncthreads();

      // the scores are done with the split tile: the next one goes in
      if (more) split_raw<D>(s.xm, s.xr[cur ^ 1]);
      if (mixer) {
        // A = X^T of the tile
        auto frag = [&](int j, uint32_t (&ab)[4], uint32_t (&as)[4]) {
          transposed_frag<D>(s.xr[cur], fr, j, ab, as);
        };
        float al[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) al[i] = s.alpha[(i / 2) * 8 + 2 * tq + i % 2];
        // sum_m (e gate)[n, m] x_m
        float part[1][32];
        chain<NT / 8, 1>(part, frag, [&](int, int j) { return &s.ew[j][0][0]; });
#pragma unroll
        for (int i = 0; i < 32; ++i) out[i] = out[i] * al[2 * (i / 4) + i % 2] + part[0][i];
        if (last) {  // y = out scale2 / l; a warp's store covers 4 rows x 8 features
          float* yrow = y + off + fr;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int row = (i / 2) * 8 + 2 * tq + i % 2;
            if (n0 + row < n) {
              const float f = s.yscale[row];
#pragma unroll
              for (int h = 0; h < 2; ++h)
                yrow[(n0 + row) * node_stride + 8 * h] = out[4 * (i / 2) + 2 * h + i % 2] * f;
            }
          }
        }
      }
      tc::cp_async_wait_all();  // the next item's rows
      tc::fence_proxy_async();
      __syncthreads();
      cur ^= 1;
    }
  }
}

template <int D>
int launch_tc(const void* x, const void* gate, void* y, int b, int n, int t_len, float scale1,
              float scale2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gcn_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(FwdSmem<D>));
  if (err != cudaSuccess) return (int)err;
  const int64_t items = (int64_t)((n + NT - 1) / NT) * t_len * b;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min<int64_t>(items, sm_count());
  gcn_fwd_tc_kernel<D><<<grid, THREADS, sizeof(FwdSmem<D>), stream>>>(
      (const float*)x, (const float*)gate, (float*)y, b, n, t_len, scale1, scale2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pxt_gcn_fwd_smem_bytes(int n, int d) {
  if (d == 128) return (int)sizeof(FwdSmem<128>);
  if (d == 64) return (int)sizeof(FwdSmem<64>);
  return (n * (d + 1) + kRowsPerCta * n) * (int)sizeof(float);
}

extern "C" int pxt_gcn_fwd_f32(const void* x, const void* gate, void* y, int b,
                               int n, int t_len, int d, float scale1,
                               float scale2, void* stream) {
  if (d % 32 != 0 || d > 32 * kMaxDk) return (int)cudaErrorInvalidValue;
  if ((int64_t)b * n * t_len == 0) return 0;
  if (d == 128) return launch_tc<128>(x, gate, y, b, n, t_len, scale1, scale2, (cudaStream_t)stream);
  if (d == 64) return launch_tc<64>(x, gate, y, b, n, t_len, scale1, scale2, (cudaStream_t)stream);
  const int smem = pxt_gcn_fwd_smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowsPerCta - 1) / kRowsPerCta, t_len, b);
  gcn_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gate, (float*)y, n, t_len, d, scale1,
      scale2);
  return (int)cudaGetLastError();
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
