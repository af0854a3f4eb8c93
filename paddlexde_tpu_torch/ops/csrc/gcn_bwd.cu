// Fused spatial-attention GCN mixing (backward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddlexde_tpu/ops/gcn_pallas.py
// (_bwd_kernel, launched by _pallas_bwd in the custom VJP of
// gcn_spatial_mix). For every (batch b, time t) slice X = x[b, :, t, :] and
// G = g[b, :, t, :], both [N, D], with s = X X^T scale1, p0 = softmax_rows(s),
// a = p0 scale2 (.) gate and da = G X^T:
//
//   dx    = a^T G + scale1 (ds + ds^T) X,
//   ds    = p0 (.) (scale2 gate (.) da - r),  r_n = sum_m p0 scale2 gate da,
//   dgate = sum_{b,t} p0 scale2 (.) da.
//
// Design: FlashAttention-2's backward shape, three kernels per call.
//
// 1. gcn_bwd_row_kernel: one CTA per (32 rows n, t, b), 4 warps of 8 rows;
//    the node axis m streams through shared memory in tiles of 64. It takes
//    the row softmax online (running max and sum) and, with the same
//    rescaling, r_n and the two mixes sum_m e gate da x_m and sum_m e x_m,
//    so one sweep yields the row half of dx:
//      dx_row[n] = scale1 (scale2 U_n / l_n - r_n V_n / l_n).
//    It writes dx_row into dx and the row statistics (max, sum, r) into a
//    [B*T, 3, N] scratch.
// 2. gcn_bwd_col_kernel: one CTA per (32 columns m, t, b); rows n stream in
//    tiles of 64 with x_n and g_n. From the statistics it recomputes p0 and
//    ds for its columns and adds sum_n a[n,m] g_n + scale1 sum_n ds[n,m] x_n
//    to dx[m]. It also writes p0 scale2 da of its columns, transposed, as a
//    per-slice partial of dgate ([B*T, N, N]: a plain store, coalesced over
//    n).
// 3. gcn_bwd_dgate_kernel sums the B*T partials of each gate entry in slice
//    order.
//
// The TPU kernel zeroes dgate at grid step 0 and accumulates with += over
// the batch grid; that relies on the TPU running the grid in order. Here
// every partial is written once by one thread and summed in a fixed order:
// no atomics, so the result is the same bits from run to run.
//
// Bound: operations (five N^2 D products per slice at the least; this
// design does eight: scores and g x^T in both passes, two mixes in each) in
// float32 on the CUDA cores, against 3 N D floats moved per slice. The
// dgate partials add 8 B T N^2 bytes of traffic (44 MB at PEMS08, batch 32).
// D = 64 and D = 128 only; any N.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int RPW = 8;              // rows (or columns) per warp
constexpr int ROWS = WARPS * RPW;   // per CTA
constexpr int MT = 64;              // nodes per streamed tile
constexpr int TJ = MT / 32;         // node slots per lane per tile

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// rows r0 .. r0+count-1 of a [N, D] slice (node stride in floats) into
// dst [count][D+4] with cp.async; rows past N become zeros. Not waited on.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0,
                                           int count, int n, int64_t node_stride) {
  constexpr int Q = D / 4;
  for (int u = threadIdx.x; u < count * Q; u += blockDim.x) {
    const int r = u / Q;
    const int q = u - r * Q;
    float* d = dst + r * (D + 4) + q * 4;
    if (r0 + r < n)
      cp_async16(d, src + (r0 + r) * node_stride + q * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__host__ __device__ constexpr int row_smem_bytes() {
  return ((2 * ROWS + MT) * (D + 4) + 2 * ROWS * MT) * (int)sizeof(float);
}

template <int D>
__host__ __device__ constexpr int col_smem_bytes() {
  return ((ROWS + 2 * MT) * (D + 4) + 2 * ROWS * MT) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
gcn_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ gate, float* __restrict__ dx,
                   float* __restrict__ stats, int n, int t_len, float scale1, float scale2) {
  constexpr int LD = D + 4;
  constexpr int FPL = D / 32;
  extern __shared__ __align__(16) float smem_row[];
  float* sx = smem_row;         // [ROWS][LD]: this CTA's rows of x
  float* sg = sx + ROWS * LD;   // [ROWS][LD]: this CTA's rows of g
  float* sk = sg + ROWS * LD;   // [MT][LD]: one tile of x
  float* pw0 = sk + MT * LD;    // [ROWS][MT]: e
  float* pw1 = pw0 + ROWS * MT; // [ROWS][MT]: e gate da
  const int t = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bt = b * t_len + t;
  const int64_t node_stride = (int64_t)t_len * D;
  const int64_t off = (b * n * t_len + t) * (int64_t)D;
  const float* xbt = x + off;
  const float* gbt = g + off;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_base = blockIdx.x * ROWS;
  const int lr0 = warp * RPW;
  const int row0 = row_base + lr0;

  stage_rows<D>(sx, xbt, row_base, ROWS, n, node_stride);
  stage_rows<D>(sg, gbt, row_base, ROWS, n, node_stride);

  float run_max[RPW], run_sum[RPW], run_r[RPW], u_acc[RPW][FPL], v_acc[RPW][FPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    run_max[i] = -INFINITY;
    run_sum[i] = 0.f;
    run_r[i] = 0.f;
#pragma unroll
    for (int f = 0; f < FPL; ++f) u_acc[i][f] = v_acc[i][f] = 0.f;
  }

  for (int m0 = 0; m0 < n; m0 += MT) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D>(sk, xbt, m0, MT, n, node_stride);
    cp_async_wait_all();
    __syncthreads();

    // s[i][j] = x_n . x_m and da[i][j] = g_n . x_m for m = m0 + lane + 32 j
    float as[RPW][TJ], ad[RPW][TJ];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) as[i][j] = ad[i][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 xm[TJ];
#pragma unroll
      for (int j = 0; j < TJ; ++j) xm[j] = *reinterpret_cast<const float4*>(sk + (lane + 32 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 xr = *reinterpret_cast<const float4*>(sx + (lr0 + i) * LD + c);
        const float4 gr = *reinterpret_cast<const float4*>(sg + (lr0 + i) * LD + c);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          as[i][j] = dot4(xr, xm[j], as[i][j]);
          ad[i][j] = dot4(gr, xm[j], ad[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        as[i][j] *= scale1;
        if (m0 + lane + 32 * j < n) tmax = fmaxf(tmax, as[i][j]);
      }
      const float new_max = fmaxf(run_max[i], warp_max(tmax));
      const float alpha = expf(run_max[i] - new_max);  // 0 on the first tile
      const float* grow = gate + (int64_t)min(row0 + i, n - 1) * n;
      float tsum = 0.f, tr = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int m = m0 + lane + 32 * j;
        const float e = m < n ? expf(as[i][j] - new_max) : 0.f;
        const float w = m < n ? e * (grow[m] * ad[i][j]) : 0.f;
        tsum += e;
        tr += w;
        pw0[(lr0 + i) * MT + lane + 32 * j] = e;
        pw1[(lr0 + i) * MT + lane + 32 * j] = w;
      }
      run_sum[i] = run_sum[i] * alpha + warp_sum(tsum);
      run_r[i] = run_r[i] * alpha + warp_sum(tr);
      run_max[i] = new_max;
#pragma unroll
      for (int f = 0; f < FPL; ++f) {
        u_acc[i][f] *= alpha;
        v_acc[i][f] *= alpha;
      }
    }
    __syncwarp();

    // U += (e gate da) X_tile, V += e X_tile: lane owns features FPL*lane..
    for (int m = 0; m < MT; m += 4) {
      float xv[4][FPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) ldv(sk + (m + u) * LD + lane * FPL, xv[u]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p0 = *reinterpret_cast<const float4*>(pw0 + (lr0 + i) * MT + m);
        const float4 p1 = *reinterpret_cast<const float4*>(pw1 + (lr0 + i) * MT + m);
        const float e0[4] = {p0.x, p0.y, p0.z, p0.w};
        const float e1[4] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int f = 0; f < FPL; ++f) {
            v_acc[i][f] = fmaf(e0[u], xv[u][f], v_acc[i][f]);
            u_acc[i][f] = fmaf(e1[u], xv[u][f], u_acc[i][f]);
          }
      }
    }
    __syncwarp();
  }

  float* st = stats + bt * 3 * n;  // [3][n]: max, sum, r
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + i;
    if (row >= n) break;
    const float inv = 1.f / run_sum[i];
    const float r = scale2 * run_r[i] * inv;
    float out[FPL];
#pragma unroll
    for (int f = 0; f < FPL; ++f)
      out[f] = scale1 * (scale2 * u_acc[i][f] * inv - r * (v_acc[i][f] * inv));
    stv(dx + ((b * n + row) * t_len + t) * (int64_t)D + lane * FPL, out);
    if (lane == 0) {
      st[row] = run_max[i];
      st[n + row] = run_sum[i];
      st[2 * n + row] = r;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
gcn_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ gate, const float* __restrict__ stats,
                   float* __restrict__ dx, float* __restrict__ pdg, int n, int t_len,
                   float scale1, float scale2) {
  constexpr int LD = D + 4;
  constexpr int FPL = D / 32;
  extern __shared__ __align__(16) float smem_col[];
  float* sc = smem_col;        // [ROWS][LD]: x of this CTA's columns
  float* sx = sc + ROWS * LD;  // [MT][LD]: a tile of x rows
  float* sg = sx + MT * LD;    // [MT][LD]: the same tile of g rows
  float* wa = sg + MT * LD;    // [ROWS][MT]: a = p0 scale2 gate
  float* wd = wa + ROWS * MT;  // [ROWS][MT]: scale1 ds
  const int t = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t bt = b * t_len + t;
  const int64_t node_stride = (int64_t)t_len * D;
  const int64_t off = (b * n * t_len + t) * (int64_t)D;
  const float* xbt = x + off;
  const float* gbt = g + off;
  const float* st = stats + bt * 3 * n;
  float* pdg_bt = pdg + bt * (int64_t)n * n;  // [m][n]: transposed partial
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col_base = blockIdx.x * ROWS;
  const int lc0 = warp * RPW;
  const int col0 = col_base + lc0;

  stage_rows<D>(sc, xbt, col_base, ROWS, n, node_stride);

  float acc[RPW][FPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int f = 0; f < FPL; ++f) acc[i][f] = 0.f;

  for (int n0 = 0; n0 < n; n0 += MT) {
    __syncthreads();
    stage_rows<D>(sx, xbt, n0, MT, n, node_stride);
    stage_rows<D>(sg, gbt, n0, MT, n, node_stride);
    cp_async_wait_all();
    __syncthreads();

    // s[i][j] = x_n . x_m and da[i][j] = g_n . x_m for n = n0 + lane + 32 j
    float as[RPW][TJ], ad[RPW][TJ];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) as[i][j] = ad[i][j] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float4 xn[TJ], gn[TJ];
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        xn[j] = *reinterpret_cast<const float4*>(sx + (lane + 32 * j) * LD + c);
        gn[j] = *reinterpret_cast<const float4*>(sg + (lane + 32 * j) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 xc = *reinterpret_cast<const float4*>(sc + (lc0 + i) * LD + c);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          as[i][j] = dot4(xn[j], xc, as[i][j]);
          ad[i][j] = dot4(gn[j], xc, ad[i][j]);
        }
      }
    }

    float row_max[TJ], row_inv[TJ], row_r[TJ];
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int nn = n0 + lane + 32 * j;
      row_max[j] = nn < n ? st[nn] : 0.f;
      row_inv[j] = nn < n ? 1.f / st[n + nn] : 0.f;
      row_r[j] = nn < n ? st[2 * n + nn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int m = col0 + i;
      const int mc = min(m, n - 1);
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int nn = n0 + lane + 32 * j;
        float a = 0.f, dsv = 0.f;
        if (nn < n) {
          const float p0 = expf(as[i][j] * scale1 - row_max[j]) * row_inv[j];
          const float gt = gate[(int64_t)nn * n + mc];
          a = p0 * scale2 * gt;
          dsv = scale1 * (p0 * (scale2 * gt * ad[i][j] - row_r[j]));
          if (m < n) pdg_bt[(int64_t)m * n + nn] = p0 * scale2 * ad[i][j];
        }
        wa[(lc0 + i) * MT + lane + 32 * j] = a;
        wd[(lc0 + i) * MT + lane + 32 * j] = dsv;
      }
    }
    __syncwarp();

    // acc[m] += sum_n a[n, m] g_n + scale1 ds[n, m] x_n
    for (int k = 0; k < MT; k += 4) {
      float xv[4][FPL], gv[4][FPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ldv(sx + (k + u) * LD + lane * FPL, xv[u]);
        ldv(sg + (k + u) * LD + lane * FPL, gv[u]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(wa + (lc0 + i) * MT + k);
        const float4 d4 = *reinterpret_cast<const float4*>(wd + (lc0 + i) * MT + k);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int f = 0; f < FPL; ++f)
            acc[i][f] = fmaf(dv[u], xv[u][f], fmaf(av[u], gv[u][f], acc[i][f]));
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int m = col0 + i;
    if (m >= n) break;
    float* p = dx + ((b * n + m) * t_len + t) * (int64_t)D + lane * FPL;
    float cur[FPL];
    ldv(p, cur);
#pragma unroll
    for (int f = 0; f < FPL; ++f) cur[f] += acc[i][f];
    stv(p, cur);
  }
}

// dgate[n, m] = sum over the B*T slices, in slice order, of pdg[slice, m, n]
__global__ void gcn_bwd_dgate_kernel(const float* __restrict__ pdg, float* __restrict__ dgate,
                                     int n, int slices) {
  const int64_t nn2 = (int64_t)n * n;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;  // m * n + row
  if (idx >= nn2) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += pdg[k * nn2 + idx];
  const int64_t m = idx / n;
  const int64_t row = idx - m * n;
  dgate[row * n + m] = s;
}

template <int D>
int launch(const float* x, const float* g, const float* gate, float* dx, float* dgate,
           float* scratch, int b, int n, int t_len, float scale1, float scale2,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gcn_bwd_row_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         row_smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcn_bwd_col_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             col_smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  const int slices = b * t_len;
  float* stats = scratch;                          // [B*T][3][N]
  float* pdg = scratch + (int64_t)slices * 3 * n;  // [B*T][N][N]
  dim3 grid((n + ROWS - 1) / ROWS, t_len, b);
  gcn_bwd_row_kernel<D><<<grid, WARPS * 32, row_smem_bytes<D>(), stream>>>(
      x, g, gate, dx, stats, n, t_len, scale1, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcn_bwd_col_kernel<D><<<grid, WARPS * 32, col_smem_bytes<D>(), stream>>>(
      x, g, gate, stats, dx, pdg, n, t_len, scale1, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nn2 = (int64_t)n * n;
  gcn_bwd_dgate_kernel<<<(unsigned)((nn2 + 255) / 256), 256, 0, stream>>>(pdg, dgate, n, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of scratch one call needs: row statistics and the dgate partials
extern "C" int64_t pxt_gcn_bwd_scratch_floats(int b, int n, int t_len) {
  const int64_t slices = (int64_t)b * t_len;
  return slices * 3 * n + slices * n * (int64_t)n;
}

extern "C" int pxt_gcn_bwd_f32(const void* x, const void* g, const void* gate, void* dx,
                               void* dgate, void* scratch, int b, int n, int t_len, int d,
                               float scale1, float scale2, void* stream) {
  if ((int64_t)b * n * t_len == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* gf = (const float*)g;
  const float* gt = (const float*)gate;
  if (d == 128)
    return launch<128>(xf, gf, gt, (float*)dx, (float*)dgate, (float*)scratch, b, n, t_len,
                       scale1, scale2, s);
  if (d == 64)
    return launch<64>(xf, gf, gt, (float*)dx, (float*)dgate, (float*)scratch, b, n, t_len,
                      scale1, scale2, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
