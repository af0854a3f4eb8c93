// Fused spatial-attention GCN mixing (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/gcn_pallas.py
// (_fwd_kernel, launched by _pallas_fwd for gcn_spatial_mix). For every
// (batch b, time t) slice X = x[b, :, t, :] of shape [N, D]:
//
//   y[b, n, t, :] = sum_m softmax_m(X[n] . X[m] * scale1) * scale2
//                   * gate[n, m] * X[m]
//
// Design. One CTA per (row tile of 32 nodes, t, b), 8 warps of 4 rows each.
// The whole X slice is staged once into shared memory (N x (D+1) floats;
// 87.7 KB at N=170, D=128, so the dynamic shared-memory opt-in is set). The
// row stride D+1 keeps the score loop (lane = node m, running over D) free
// of bank conflicts. Each warp computes its 4 score rows into a per-warp
// shared buffer, takes the row softmax with warp shuffles, folds scale2 and
// the gate row in, then multiplies by X with lane = feature. The [N, N]
// score block never reaches device memory; x is read and y written once
// (the re-reads of X by the other row tiles of the same slice hit L2).
//
// Bound: operations (4 N^2 D flops per slice in float32 on the CUDA cores,
// against 2 N D floats moved). float32 only in this version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// D = 128 (every configuration the repo ships except the synthetic one): a
// register-tiled kernel for any N. Same CTA grid (32 rows of one (b, t)
// slice per CTA), 4 warps of 8 rows. The CTA's rows are staged once; the
// nodes stream through shared memory in tiles of MT = 64 (row stride D+4
// floats: 16-byte aligned, conflict-free float4 reads), staged with
// cp.async. Scores: lane l holds 8 rows x nodes {l, l+32} of the tile.
// Softmax online across tiles; the gated exponentials go to a per-warp
// shared buffer. Mix: lane l holds the 8 rows x features 4l..4l+3 and reads
// 4 nodes of probabilities and 4 rows of X per step. Tiles beat staging the
// whole slice even where it fits: 59 KB admit 3 CTAs per SM, and an H100
// measured the whole-slice variant slower at N=170, no faster at N=80
// (PERF.md).
// ---------------------------------------------------------------------------

namespace d128 {

constexpr int D = 128;
constexpr int LD = D + 4;
constexpr int WARPS = 4;
constexpr int RPW = 8;              // rows per warp
constexpr int ROWS = WARPS * RPW;   // rows per CTA
constexpr int MT = 64;              // nodes per tile
constexpr int TJ = MT / 32;         // node slots per lane per tile

__host__ __device__ constexpr int smem_bytes() {
  return ((ROWS + MT) * LD + ROWS * MT) * (int)sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Each row's softmax is taken online (running max and sum, the accumulated
// output rescaled when the max grows), as in flash attention:
// y = scale2 / sum_m e_m * sum_m e_m gate[n, m] X[m], e_m = exp(s_m - max).
// Any N fits in 59 KB of shared memory.
__global__ void __launch_bounds__(WARPS * 32)
gcn_fwd_d128_tiled_kernel(const float* __restrict__ x, const float* __restrict__ gate,
                          float* __restrict__ y, int n, int t_len, float scale1, float scale2) {
  extern __shared__ __align__(16) float smem_tiled[];
  float* sq = smem_tiled;        // [ROWS][LD]: this CTA's rows
  float* sk = sq + ROWS * LD;    // [MT][LD]: one tile of nodes
  float* sp = sk + MT * LD;      // [ROWS][MT]: gated exponentials of the tile
  const int t = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t node_stride = (int64_t)t_len * D;
  const float* xbt = x + (b * n * t_len + t) * (int64_t)D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_base = blockIdx.x * ROWS;

  for (int r = warp; r < ROWS; r += WARPS) {
    float* dst = sq + r * LD + lane * 4;
    if (row_base + r < n)
      cp_async16(dst, xbt + (row_base + r) * node_stride + lane * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int lr0 = warp * RPW;  // this warp's first row in sq
  const int row0 = row_base + lr0;
  float run_max[RPW], run_sum[RPW], out[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    run_max[i] = -INFINITY;
    run_sum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[i][e] = 0.f;
  }
  float* pw = sp + lr0 * MT;

  for (int m0 = 0; m0 < n; m0 += MT) {
    __syncthreads();  // every warp is done with the previous tile
    for (int m = warp; m < MT; m += WARPS) {
      float* dst = sk + m * LD + lane * 4;
      if (m0 + m < n)
        cp_async16(dst, xbt + (m0 + m) * node_stride + lane * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float acc[RPW][TJ];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 xr[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) xr[i] = *reinterpret_cast<const float4*>(sq + (lr0 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const float4 xm = *reinterpret_cast<const float4*>(sk + (lane + 32 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float a = acc[i][j];
          a = fmaf(xr[i].x, xm.x, a);
          a = fmaf(xr[i].y, xm.y, a);
          a = fmaf(xr[i].z, xm.z, a);
          a = fmaf(xr[i].w, xm.w, a);
          acc[i][j] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        acc[i][j] *= scale1;
        if (m0 + lane + 32 * j < n) tmax = fmaxf(tmax, acc[i][j]);
      }
      const float new_max = fmaxf(run_max[i], warp_max(tmax));
      const float alpha = expf(run_max[i] - new_max);  // 0 on the first tile
      const float* grow = gate + (int64_t)min(row0 + i, n - 1) * n;
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int m = m0 + lane + 32 * j;
        const float e = m < n ? expf(acc[i][j] - new_max) : 0.f;
        tsum += e;
        pw[i * MT + lane + 32 * j] = m < n ? e * grow[m] : 0.f;
      }
      run_sum[i] = run_sum[i] * alpha + warp_sum(tsum);
      run_max[i] = new_max;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[i][e] *= alpha;
    }
    __syncwarp();

    for (int m = 0; m < MT; m += 4) {
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = *reinterpret_cast<const float4*>(sk + (m + u) * LD + lane * 4);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + i * MT + m);
        const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          out[i][0] = fmaf(pu[u], xv[u].x, out[i][0]);
          out[i][1] = fmaf(pu[u], xv[u].y, out[i][1]);
          out[i][2] = fmaf(pu[u], xv[u].z, out[i][2]);
          out[i][3] = fmaf(pu[u], xv[u].w, out[i][3]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (row0 + i >= n) break;
    const float f = scale2 / run_sum[i];
    *reinterpret_cast<float4*>(y + ((b * n + row0 + i) * t_len + t) * (int64_t)D + lane * 4) =
        make_float4(out[i][0] * f, out[i][1] * f, out[i][2] * f, out[i][3] * f);
  }
}

int launch(const void* x, const void* gate, void* y, int b, int n, int t_len, float scale1,
           float scale2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gcn_fwd_d128_tiled_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + ROWS - 1) / ROWS, t_len, b);
  gcn_fwd_d128_tiled_kernel<<<grid, WARPS * 32, smem_bytes(), stream>>>(
      (const float*)x, (const float*)gate, (float*)y, n, t_len, scale1, scale2);
  return (int)cudaGetLastError();
}

}  // namespace d128

extern "C" int pxt_gcn_fwd_smem_bytes(int n, int d) {
  if (d == d128::D) return d128::smem_bytes();
  return (n * (d + 1) + kRowsPerCta * n) * (int)sizeof(float);
}

extern "C" int pxt_gcn_fwd_f32(const void* x, const void* gate, void* y, int b,
                               int n, int t_len, int d, float scale1,
                               float scale2, void* stream) {
  if (d % 32 != 0 || d > 32 * kMaxDk) return (int)cudaErrorInvalidValue;
  if ((int64_t)b * n * t_len == 0) return 0;
  if (d == d128::D)
    return d128::launch(x, gate, y, b, n, t_len, scale1, scale2, (cudaStream_t)stream);
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
