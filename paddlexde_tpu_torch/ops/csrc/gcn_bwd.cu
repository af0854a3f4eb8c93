// Fused spatial-attention GCN mixing (backward), for Hopper (sm_90a), with
// its N^2 D products on the tensor cores in 3xTF32.
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
// Design: FlashAttention-2's backward shape, three kernels per call, each
// CTA two warpgroups (256 threads) and node tiles of NT = 64.
//
// 1. gcn_bwd_row_tc_kernel: one persistent CTA per SM walks the work
//    items (64 rows n, t, b); the nodes m stream through shared memory in
//    tiles of 64. Warpgroup 0 takes the scores s[n, m] = x_n . x_m,
//    warpgroup 1 da[n, m] = g_n . x_m, both as wgmma m64n64k8 (A the
//    item's rows as they are, split as they are read; B the tile of x,
//    split once into K-major core matrices: tc::b_offset). The two then
//    take the row softmax online (running max and sum) and r_n on the CUDA
//    cores, each for half of the rows, and write e and e gate da to shared
//    memory, split, as the B operands of the two mixes U^T = X^T
//    (e gate da)^T and V^T = X^T e^T (M = features: warpgroup w takes
//    features 64 w .. 64 w + 63; A = X^T read from the split tile, once for
//    both mixes). The online rescaling by alpha joins each chain's flush.
//    The next item's rows are copied in under the last tile's mixes. One
//    sweep yields the row half of dx,
//      dx_row[n] = scale1 (scale2 U_n / l_n - r_n V_n / l_n),
//    and the row statistics (max, sum, r) in a [B*T, 3, N] scratch.
// 2. gcn_bwd_col_tc_kernel: one CTA per (64 columns m, b, group of
//    steps), looping over the group's steps t; rows n stream in tiles of
//    64. The scores and da come as in the row pass (the same operands, the
//    same products), p0, a and scale1 ds of its columns from the
//    statistics, and
//      dx[m] += sum_n a[n, m] g_n + scale1 ds[n, m] x_n
//    on the tensor cores (M = features, A = G^T and X^T from the raw tiles,
//    B = a and ds, split). p0 scale2 da of its columns adds, over the
//    group's steps in order, into one dgate partial per (b, group)
//    ([B, groups, N, N]; each entry read and written by one thread only).
//    The groups (t_groups: 1 to 4) fill the SMs' waves. Each row tile of x
//    and g is copied in under the previous tile's mixes.
// 3. gcn_bwd_dgate_kernel sums the B groups partials of each gate entry in
//    order.
//
// The TPU kernel zeroes dgate at grid step 0 and accumulates with += over
// the batch grid; that relies on the TPU running the grid in order. Here
// every partial is owned by one thread and summed in a fixed order: no
// atomics, so the result is the same bits from run to run.
//
// 3xTF32 (tc_conv.cuh): every operand splits into big = tf32(v) and
// small = v - big, and a b ~ small_a big_b + big_a small_b + big_a big_b.
// The tensor cores' float32 accumulation is not round-to-nearest, so each
// chain of CH k-steps (3 CH products: half of a D = 128 score, one
// operand's 64-node mix) starts a fresh accumulator that is added to a
// float32 sum on the CUDA cores.
//
// Bound: operations (five N^2 D products per slice at the least; this
// design does eight: scores and g x^T in both passes, two mixes in each)
// in 3xTF32 on the tensor cores, against 3 N D floats moved per slice; the
// dgate partials take B groups N^2 floats of scratch (14.8 MB at PEMS08,
// batch 32, 4 groups; one per slice took 44 MB).
// D = 64 and D = 128 only (at D = 64 warpgroup 1 takes no mix); any N.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tc_conv.cuh"

namespace {

constexpr int NT = 64;           // nodes per tile (the m64 / n64 of wgmma)
constexpr int THREADS = 256;     // two warpgroups
constexpr int TILE = NT * 8;     // floats of one split B tile of 8 k, one term
constexpr int CH = 8;            // k-steps per tensor-core chain (24 products)
constexpr int MAX_GROUPS = 4;    // groups of steps per column block and batch
constexpr int EX = 72;           // row stride of the da exchange tile

template <int D>
struct RowSmem {
  float xn[NT][D + 4];          // the CTA's rows of x, as they are
  float gn[NT][D + 4];          // the CTA's rows of g, as they are
  float xm[D / 8][2][TILE];     // a tile of x split (k = features): B of the scores
  float ew[NT / 8][2][2][TILE]; // [k-block of m][e | e gate da][big | small], N = n
  float ex[NT][EX];             // s or da of the rows the other warpgroup takes
  float alpha[NT];
  float lsum[NT];
  float rsum[NT];
};

template <int D>
struct ColSmem {
  float xn[NT][D + 4];          // a tile of x rows, as they are
  float gn[NT][D + 4];          // the same tile of g rows
  float xm[D / 8][2][TILE];     // the CTA's columns of x split: B of the scores
  float ad[NT / 8][2][2][TILE]; // [k-block of n][a | scale1 ds][big | small], N = m
  float ex[NT][EX];
};

// the first of a thread's two rows (the other is 8 further) in its
// warpgroup's m64 fragment
__device__ __forceinline__ int wg_row() {
  const int t = threadIdx.x & 127;
  return (t >> 5) * 16 + ((t & 31) >> 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v split into a B tile pair: big at tile[off], small at tile[TILE + off]
__device__ __forceinline__ void put_split_at(float* tile, int off, float v) {
  uint32_t big, small;
  tc::split_tf32(v, big, small);
  tile[off] = __uint_as_float(big);
  tile[TILE + off] = __uint_as_float(small);
}

// nodes r0 .. r0 + NT - 1 of a [N, D] slice (node stride in floats) -> dst
// as they are (cp.async, zeros past n; not committed)
template <int D>
__device__ __forceinline__ void stage_raw(float (*dst)[D + 4], const float* __restrict__ src,
                                          int r0, int n, int64_t node_stride) {
  for (int u = threadIdx.x; u < NT * (D / 4); u += THREADS) {
    const int r = u / (D / 4);
    const int q = u % (D / 4);
    const bool full = r0 + r < n;
    tc::cp_async16_zfill(&dst[r][4 * q], src + (full ? (int64_t)(r0 + r) * node_stride + 4 * q : 0),
                         full);
  }
}

// nodes r0 .. r0 + NT - 1 of a [N, D] slice -> dst split, K-major over the
// features (k-block f / 8, tc::b_offset(node, f % 8)); zeros past n. Every
// load is in flight before the first store. A quarter warp takes 8 nodes of
// one float4 column: its 16-byte stores hit distinct banks.
template <int D>
__device__ __forceinline__ void stage_split(float (*dst)[2][TILE], const float* __restrict__ src,
                                            int r0, int n, int64_t node_stride) {
  constexpr int Q = D / 4;
  constexpr int ITER = NT * Q / THREADS;
  float4 v[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = (u >> 3) / Q * 8 + (u & 7);
    const int q = (u >> 3) % Q;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v[i] = __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * node_stride + 4 * q));
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = (u >> 3) / Q * 8 + (u & 7);
    const int q = (u >> 3) % Q;
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    tc::split_tf32(v[i].x, b0, s0);
    tc::split_tf32(v[i].y, b1, s1);
    tc::split_tf32(v[i].z, b2, s2);
    tc::split_tf32(v[i].w, b3, s3);
    const int off = tc::b_offset(r, (4 * q) % 8);
    *reinterpret_cast<uint4*>(&dst[q / 2][0][off]) = make_uint4(b0, b1, b2, b3);
    *reinterpret_cast<uint4*>(&dst[q / 2][1][off]) = make_uint4(s0, s1, s2, s3);
  }
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// parts[p] = sum over KS k-steps j of A_j B_pj in 3xTF32 on the tensor
// cores, for NP products that share A: frag(j, big, small) reads and splits
// the thread's A fragment of k-step j, b(p, j) is product p's split B tile
// of k-step j (big; small TILE floats further). A fragments in two register
// buffers: k-step j's is read while j - 1 runs.
template <int KS, int NP, typename Frag, typename BTile>
__device__ __forceinline__ void chain(float (&parts)[NP][32], Frag frag, BTile b) {
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int buf = j & 1;
    if (j >= 2) {  // k-step j - 2 read this buffer
      wgmma_wait_one();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tc::hold(ab[buf][i]);
        tc::hold(as[buf][i]);
      }
    }
    frag(j, ab[buf], as[buf]);
    tc::wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float* tile = b(p, j);
      const uint64_t big = tc::desc_b(tile);
      const uint64_t small = tc::desc_b(tile + TILE);
      tc::wgmma_n64(parts[p], as[buf], big, j > 0);
      tc::wgmma_n64(parts[p], ab[buf], small, 1);
      tc::wgmma_n64(parts[p], ab[buf], big, 1);
    }
    tc::wgmma_commit();
  }
  tc::wgmma_wait_all();
#pragma unroll
  for (int buf = 0; buf < 2; ++buf)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tc::hold(ab[buf][i]);
      tc::hold(as[buf][i]);
    }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) tc::hold(parts[p][i]);
}

// acc[n, m] = sum_f a[n][f] xm[m][f] for the warpgroup's 64 rows n of a
// (as they are, split here) and the 64 nodes m of the split tile xm, in
// chains of CH k-steps. acc in the m64n64 fragment: acc[4 nb + 2 h + e] is
// (row wg_row() + 8 h, column 8 nb + 2 (lane % 4) + e).
template <int D>
__device__ __forceinline__ void score_tile(const float (*a)[D + 4], const float (*xm)[2][TILE],
                                           float (&acc)[32]) {
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += CH) {
    float part[1][32];
    chain<CH, 1>(
        part,
        [&](int j, uint32_t (&ab)[4], uint32_t (&as)[4]) {
          const int c = (k0 + j) * 8 + tq;
          tc::split_tf32(a[r][c], ab[0], as[0]);
          tc::split_tf32(a[r + 8][c], ab[1], as[1]);
          tc::split_tf32(a[r][c + 4], ab[2], as[2]);
          tc::split_tf32(a[r + 8][c + 4], ab[3], as[3]);
        },
        [&](int, int j) { return xm[k0 + j][0]; });
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[0][i];
  }
}

// The elementwise work between the products is split by rows: warpgroup w
// takes rows wg_row() + 8 w of the tile. Warpgroup 0 holds s and warpgroup
// 1 da for all 64 rows; each writes the half it does not take to ex.
__device__ __forceinline__ void swap_out(float (*ex)[EX], const float (&acc)[32], int wg) {
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    float2* p = reinterpret_cast<float2*>(&ex[r + 8 * (1 - wg)][nb * 8 + 2 * tq]);
    *p = wg == 0 ? make_float2(acc[4 * nb + 2], acc[4 * nb + 3])
                 : make_float2(acc[4 * nb], acc[4 * nb + 1]);
  }
}

// after a barrier: s and da of the thread's row wg_row() + 8 wg at the
// columns 8 nb + 2 (lane % 4) + e, as sv[2 nb + e] and dv[2 nb + e]
__device__ __forceinline__ void swap_in(const float (*ex)[EX], const float (&acc)[32], int wg,
                                        float (&sv)[16], float (&dv)[16]) {
  const int rl = wg_row() + 8 * wg;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mine = wg == 0 ? acc[4 * nb + e] : acc[4 * nb + 2 + e];
      const float other = ex[rl][nb * 8 + 2 * tq + e];
      sv[2 * nb + e] = wg == 0 ? mine : other;
      dv[2 * nb + e] = wg == 0 ? other : mine;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
gcn_bwd_row_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ gate, float* __restrict__ dx,
                      float* __restrict__ stats, int nb, int n, int t_len, float scale1,
                      float scale2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  RowSmem<D>& s = *reinterpret_cast<RowSmem<D>*>(smem_raw);
  const int64_t node_stride = (int64_t)t_len * D;
  const int wg = threadIdx.x >> 7;
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
  const bool mixer = wg < D / 64;  // warpgroup w mixes features 64 w .. 64 w + 63
  const int fr = wg * 64 + r;      // its features fr and fr + 8
  const int rl = r + 8 * wg;       // the row of the thread's online softmax
  const int tiles = (n + NT - 1) / NT;
  const int64_t items = (int64_t)tiles * t_len * nb;
  // work item: (row block, t, b), row blocks fastest; x and g of item i
  // start at slice(i)
  auto slice = [&](int64_t i) {
    const int64_t bt = i / tiles;  // b * t_len + t
    return ((bt / t_len) * n * t_len + bt % t_len) * (int64_t)D;
  };

  if (blockIdx.x < items) {
    stage_raw<D>(s.xn, x + slice(blockIdx.x), (int)(blockIdx.x % tiles) * NT, n, node_stride);
    stage_raw<D>(s.gn, g + slice(blockIdx.x), (int)(blockIdx.x % tiles) * NT, n, node_stride);
    tc::cp_async_commit();
  }
  // persistent: each CTA takes the items blockIdx.x + k gridDim.x; the rows
  // of the next item are copied in while the last node tile of this one is
  // mixed
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t bt = item / tiles;
    const int n0 = (int)(item % tiles) * NT;
    const float* xbt = x + slice(item);
    const int64_t next = item + gridDim.x;

    float run_max = -INFINITY, run_sum = 0.f, run_r = 0.f;
    // mixers: U^T and V^T [feature, row] in the m64n64 fragment
    float u_acc[32], v_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) u_acc[i] = v_acc[i] = 0.f;

    for (int m0 = 0; m0 < n; m0 += NT) {
      stage_split<D>(s.xm, xbt, m0, n, node_stride);
      tc::cp_async_wait_all();
      tc::fence_proxy_async();
      __syncthreads();

      float sc[32];  // warpgroup 0: s[n, m]; warpgroup 1: da[n, m]
      score_tile<D>(wg == 0 ? s.xn : s.gn, s.xm, sc);
      swap_out(s.ex, sc, wg);
      __syncthreads();
      if (m0 + NT >= n && next < items) {  // the rows are read: the next item's
        stage_raw<D>(s.xn, x + slice(next), (int)(next % tiles) * NT, n, node_stride);
        stage_raw<D>(s.gn, g + slice(next), (int)(next % tiles) * NT, n, node_stride);
        tc::cp_async_commit();
      }

      {
        float sv[16], dv[16];
        swap_in(s.ex, sc, wg, sv, dv);
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          sv[i] *= scale1;
          if (m0 + (i / 2) * 8 + 2 * tq + i % 2 < n) tmax = fmaxf(tmax, sv[i]);
        }
        const float new_max = fmaxf(run_max, quad_max(tmax));
        const float alpha = expf(run_max - new_max);  // 0 on the first tile
        const float* grow = gate + (int64_t)min(n0 + rl, n - 1) * n;
        float gt[16];  // every gate load in flight at once
#pragma unroll
        for (int i = 0; i < 16; ++i) gt[i] = grow[min(m0 + (i / 2) * 8 + 2 * tq + i % 2, n - 1)];
        float tsum = 0.f, tr = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ml = (i / 2) * 8 + 2 * tq + i % 2;
          const bool ok = m0 + ml < n;
          const float ev = ok ? expf(sv[i] - new_max) : 0.f;
          const float w = ok ? ev * (gt[i] * dv[i]) : 0.f;
          tsum += ev;
          tr += w;
          const int o = tc::b_offset(rl, ml % 8);
          put_split_at(&s.ew[ml / 8][0][0][0], o, ev);
          put_split_at(&s.ew[ml / 8][1][0][0], o, w);
        }
        run_sum = run_sum * alpha + quad_sum(tsum);
        run_r = run_r * alpha + quad_sum(tr);
        run_max = new_max;
        if (tq == 0) s.alpha[rl] = alpha;
      }
      tc::fence_proxy_async();
      __syncthreads();

      if (mixer) {
        // A = X^T of the tile: (feature fr + 8 h, node 8 j + tq + 4 h2), big
        // and small as stage_split wrote them
        auto frag = [&](int j, uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int f = fr + 8 * h;
              const int o = tc::b_offset(8 * j + tq + 4 * h2, f % 8);
              ab[2 * h2 + h] = __float_as_uint(s.xm[f / 8][0][o]);
              as[2 * h2 + h] = __float_as_uint(s.xm[f / 8][1][o]);
            }
        };
        float al[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) al[i] = s.alpha[(i / 2) * 8 + 2 * tq + i % 2];
        // sum_m (e gate da)[n, m] x_m and sum_m e[n, m] x_m
        float part[2][32];
        chain<NT / 8, 2>(part, frag, [&](int p, int j) { return &s.ew[j][1 - p][0][0]; });
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          u_acc[i] = u_acc[i] * al[2 * (i / 4) + i % 2] + part[0][i];
          v_acc[i] = v_acc[i] * al[2 * (i / 4) + i % 2] + part[1][i];
        }
      }
      __syncthreads();  // the tile's buffers are free
    }

    if (tq == 0) {
      float* st = stats + bt * 3 * n;  // [3][n]: max, sum, r
      s.lsum[rl] = run_sum;
      s.rsum[rl] = run_r;
      if (n0 + rl < n) {
        st[n0 + rl] = run_max;
        st[n + n0 + rl] = run_sum;
        st[2 * n + n0 + rl] = scale2 * run_r * (1.f / run_sum);
      }
    }
    __syncthreads();
    // dx_row [row][feature], staged in the split tile's space (xn and gn
    // hold the next item's rows)
    float (*stg)[D + 4] = reinterpret_cast<float (*)[D + 4]>(&s.xm[0][0][0]);
    if (mixer) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = (i / 2) * 8 + 2 * tq + i % 2;
        const float inv = 1.f / s.lsum[row];
        const float rr = scale2 * s.rsum[row] * inv;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 4 * (i / 2) + 2 * h + i % 2;
          stg[row][fr + 8 * h] = scale1 * (scale2 * u_acc[k] * inv - rr * (v_acc[k] * inv));
        }
      }
    }
    __syncthreads();
    float* dxbt = dx + slice(item);
    for (int u = threadIdx.x; u < NT * (D / 4); u += THREADS) {
      const int row = u / (D / 4);
      const int q = u % (D / 4);
      if (n0 + row < n)
        *reinterpret_cast<float4*>(dxbt + (n0 + row) * node_stride + 4 * q) =
            *reinterpret_cast<const float4*>(&stg[row][4 * q]);
    }
    __syncthreads();  // the staging is read before the next item's tiles
  }
}

// 64 features f0 .. f0 + 63 of nodes r0 .. r0 + NT - 1 -> dst, by one
// warpgroup (cp.async, zeros past n; not committed)
template <int D>
__device__ __forceinline__ void stage_raw_half(float (*dst)[D + 4], const float* __restrict__ src,
                                               int r0, int n, int64_t node_stride, int f0) {
  for (int u = threadIdx.x & 127; u < NT * 16; u += 128) {
    const int r = u / 16;
    const int q = u % 16;
    const bool full = r0 + r < n;
    tc::cp_async16_zfill(&dst[r][f0 + 4 * q],
                         src + (full ? (int64_t)(r0 + r) * node_stride + f0 + 4 * q : 0), full);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
gcn_bwd_col_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ gate, const float* __restrict__ stats,
                      float* __restrict__ dx, float* __restrict__ pdg, int n, int t_len,
                      int t_per, float scale1, float scale2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ColSmem<D>& s = *reinterpret_cast<ColSmem<D>*>(smem_raw);
  const int64_t b = blockIdx.y;
  const int t_begin = blockIdx.z * t_per;
  const int t_end = min(t_len, t_begin + t_per);
  const int m0 = blockIdx.x * NT;
  const int64_t node_stride = (int64_t)t_len * D;
  const int wg = threadIdx.x >> 7;
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
  const bool mixer = wg < D / 64;
  const int fr = wg * 64 + r;
  const int rl = r + 8 * wg;  // the thread's row in the elementwise work
  const int tiles = (n + NT - 1) / NT;
  const int count = (t_end - t_begin) * tiles;  // (step, row tile) pairs, tiles fastest
  // [n][m]: the dgate partial of this batch and group of steps
  float* pdg_b = pdg + (b * gridDim.z + blockIdx.z) * n * (int64_t)n;
  auto slice = [&](int t) { return (b * n * t_len + t) * (int64_t)D; };

  if (count > 0) {
    stage_raw<D>(s.xn, x + slice(t_begin), 0, n, node_stride);
    stage_raw<D>(s.gn, g + slice(t_begin), 0, n, node_stride);
    tc::cp_async_commit();
  }
  float acc[32];  // mixers: (dx_col)^T [feature, column] of the step
  for (int it = 0; it < count; ++it) {
    const int t = t_begin + it / tiles;
    const int n0 = (it % tiles) * NT;
    const float* xbt = x + slice(t);
    const float* st = stats + (b * t_len + t) * 3 * n;
    if (n0 == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      stage_split<D>(s.xm, xbt, m0, n, node_stride);
    }
    tc::cp_async_wait_all();
    tc::fence_proxy_async();
    __syncthreads();

    // the gate and the dgate partial of the thread's row, loaded while the
    // tensor cores run the scores
    const int row = n0 + rl;
    const float* grow = gate + (int64_t)min(row, n - 1) * n;
    float* prow = pdg_b + (int64_t)min(row, n - 1) * n;
    float gt[16], old[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = min(m0 + (i / 2) * 8 + 2 * tq + i % 2, n - 1);
      gt[i] = grow[m];
      old[i] = t > t_begin ? prow[m] : 0.f;
    }

    float sc[32];  // warpgroup 0: s[n, m]; warpgroup 1: da[n, m]
    score_tile<D>(wg == 0 ? s.xn : s.gn, s.xm, sc);
    swap_out(s.ex, sc, wg);
    __syncthreads();

    {
      float sv[16], dv[16];
      swap_in(s.ex, sc, wg, sv, dv);
      const bool valid = row < n;
      const float rmax = valid ? st[row] : 0.f;
      const float rinv = valid ? 1.f / st[n + row] : 0.f;
      const float rr = valid ? st[2 * n + row] : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ml = (i / 2) * 8 + 2 * tq + i % 2;
        const int m = m0 + ml;
        float a = 0.f, dsv = 0.f;
        if (valid) {
          const float p0 = expf(sv[i] * scale1 - rmax) * rinv;
          a = p0 * scale2 * gt[i];
          dsv = scale1 * (p0 * (scale2 * gt[i] * dv[i] - rr));
          if (m < n) prow[m] = old[i] + p0 * scale2 * dv[i];
        }
        const int o = tc::b_offset(ml, rl % 8);
        put_split_at(&s.ad[rl / 8][0][0][0], o, a);
        put_split_at(&s.ad[rl / 8][1][0][0], o, dsv);
      }
    }
    tc::fence_proxy_async();
    __syncthreads();

    if (mixer) {
      // A = G^T or X^T of the tile: (feature fr + 8 h, node 8 j + tq + 4 h2)
      auto frag_of = [&](const float (*raw)[D + 4]) {
        return [=](int j, uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tc::split_tf32(raw[8 * j + tq + 4 * h2][fr + 8 * h], ab[2 * h2 + h],
                             as[2 * h2 + h]);
        };
      };
      // each mixer reads only its own 64 features of g and x in the mixes:
      // once a mix is done it copies those of the next tile in
      const bool more = it + 1 < count;
      const int64_t next_slice = slice(t_begin + (it + 1) / tiles);
      const int next_n0 = ((it + 1) % tiles) * NT;
      float part[1][32];
      chain<NT / 8, 1>(part, frag_of(s.gn), [&](int, int j) { return &s.ad[j][0][0][0]; });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[0][i];  // sum_n a[n, m] g_n
      if (more) stage_raw_half<D>(s.gn, g + next_slice, next_n0, n, node_stride, 64 * wg);
      chain<NT / 8, 1>(part, frag_of(s.xn), [&](int, int j) { return &s.ad[j][1][0][0]; });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[0][i];  // scale1 sum_n ds[n, m] x_n
      if (more) stage_raw_half<D>(s.xn, x + next_slice, next_n0, n, node_stride, 64 * wg);
      tc::cp_async_commit();
    }
    __syncthreads();  // the split tiles are free

    if (n0 + NT >= n) {  // the step's last row tile: dx[m] += dx_col, staged in s.ad
      float (*stg)[D + 4] = reinterpret_cast<float (*)[D + 4]>(&s.ad[0][0][0][0]);
      if (mixer) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              stg[nb * 8 + 2 * tq + e][fr + 8 * h] = acc[4 * nb + 2 * h + e];
      }
      __syncthreads();
      constexpr int ITER = NT * (D / 4) / THREADS;
      float4 cur[ITER];  // every load in flight at once
      float* dxbt = dx + slice(t);
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int u = threadIdx.x + i * THREADS;
        const int ml = min(m0 + u / (D / 4), n - 1);
        cur[i] = *reinterpret_cast<const float4*>(dxbt + ml * node_stride + 4 * (u % (D / 4)));
      }
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int u = threadIdx.x + i * THREADS;
        const int ml = u / (D / 4);
        const int q = u % (D / 4);
        if (m0 + ml < n) {
          const float4 add = *reinterpret_cast<const float4*>(&stg[ml][4 * q]);
          cur[i].x += add.x;
          cur[i].y += add.y;
          cur[i].z += add.z;
          cur[i].w += add.w;
          *reinterpret_cast<float4*>(dxbt + (m0 + ml) * node_stride + 4 * q) = cur[i];
        }
      }
    }
  }
}

// dgate[n, m] = sum over the B batch partials, in batch order
__global__ void gcn_bwd_dgate_kernel(const float* __restrict__ pdg, float* __restrict__ dgate,
                                     int n, int batches) {
  const int64_t nn2 = (int64_t)n * n;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nn2) return;
  float s = 0.f;
  for (int k = 0; k < batches; ++k) s += pdg[k * nn2 + idx];
  dgate[idx] = s;
}

// SMs of the current card: the row kernel runs one persistent CTA on each
int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The column kernel runs one CTA per SM; its grid (column blocks x batch
// x groups of steps) fills the SMs in waves, each CTA looping over its
// steps. The number of groups (at most MAX_GROUPS) is the one whose waves
// take the fewest step rounds, the fewest groups on a tie: 4 at PEMS08
// (N = 170, batch 32: 3 waves of 3 steps against 1 wave of 12 steps on 96
// of 132 SMs), 2 at PEMS07.
int t_groups(int b, int n, int t_len) {
  const int sms = sm_count();
  const int64_t ctas = (int64_t)((n + NT - 1) / NT) * b;
  int best = 1;
  int64_t best_rounds = -1;
  for (int gcount = 1; gcount <= MAX_GROUPS && gcount <= t_len; ++gcount) {
    const int t_per = (t_len + gcount - 1) / gcount;
    const int64_t rounds = (ctas * gcount + sms - 1) / sms * t_per;
    if (best_rounds < 0 || rounds < best_rounds) {
      best = gcount;
      best_rounds = rounds;
    }
  }
  return best;
}

template <int D>
int launch(const float* x, const float* g, const float* gate, float* dx, float* dgate,
           float* scratch, int b, int n, int t_len, float scale1, float scale2,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gcn_bwd_row_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(RowSmem<D>));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcn_bwd_col_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(ColSmem<D>));
  if (err != cudaSuccess) return (int)err;
  float* stats = scratch;                                  // [B*T][3][N]
  float* pdg = scratch + (int64_t)b * t_len * 3 * n;       // [B][groups][N][N]
  const int tiles = (n + NT - 1) / NT;
  const int groups = t_groups(b, n, t_len);
  const int t_per = (t_len + groups - 1) / groups;
  const int64_t items = (int64_t)tiles * t_len * b;
  const int rows_grid = (int)std::min<int64_t>(items, sm_count());
  gcn_bwd_row_tc_kernel<D><<<rows_grid, THREADS, sizeof(RowSmem<D>), stream>>>(
      x, g, gate, dx, stats, b, n, t_len, scale1, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcn_bwd_col_tc_kernel<D><<<dim3(tiles, b, groups), THREADS, sizeof(ColSmem<D>), stream>>>(
      x, g, gate, stats, dx, pdg, n, t_len, t_per, scale1, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t nn2 = (int64_t)n * n;
  gcn_bwd_dgate_kernel<<<(unsigned)((nn2 + 255) / 256), 256, 0, stream>>>(pdg, dgate, n,
                                                                           b * groups);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of scratch one call needs on the current card: row statistics per
// slice and one dgate partial per (batch, group of steps)
extern "C" int64_t pxt_gcn_bwd_scratch_floats(int b, int n, int t_len) {
  return (int64_t)b * t_len * 3 * n + (int64_t)b * t_groups(b, n, t_len) * n * n;
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
