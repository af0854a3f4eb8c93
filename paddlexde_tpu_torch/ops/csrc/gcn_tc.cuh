// The tensor-core pieces of the GCN kernels, shared by gcn.cu (K2, the
// forward) and gcn_bwd.cu (K3, the backward).
//
// Both walk work items of 64 rows n of one (b, t) slice x [N, D] (node
// stride t_len D floats) with two warpgroups, and stream the nodes m
// through shared memory in tiles of NT = 64:
//
// - the scores x_n . x_m of a node tile are wgmma m64n64k8 TF32 products
//   (score_tile): A the item's rows as they are, split as they are read; B
//   the node tile, split once into K-major core matrices over the features
//   (stage_split, tc::b_offset);
// - the mixes contract over the nodes, so they put the features on M
//   (Y^T = X^T W^T): A = X^T is read transposed from a node tile in shared
//   memory (as it is: transposed_frag, or split), and B, the row-softmax
//   weights W, is written split into shared memory by the CUDA cores
//   (put_split_at), which hold them in the accumulator layout;
// - every product is 3xTF32 (tc_conv.cuh): small_a big_b + big_a small_b +
//   big_a big_b. The tensor cores' float32 accumulation is not
//   round-to-nearest, so a chain of at most CH k-steps (3 CH products)
//   starts a fresh accumulator, which the caller adds to a float32 sum on
//   the CUDA cores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_conv.cuh"

namespace gcn_tc {

constexpr int NT = 64;           // nodes per tile (the m64 / n64 of wgmma)
constexpr int THREADS = 256;     // two warpgroups
constexpr int TILE = NT * 8;     // floats of one split B tile of 8 k, one term
constexpr int CH = 8;            // k-steps per tensor-core chain (24 products)
constexpr int EX = 72;           // row stride of the exchange tile (swap_out)

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

// float4s of a node tile each thread loads for stage_split
template <int D>
constexpr int SPLIT_ITER = NT * (D / 4) / THREADS;

// the node and the float4 column of a tile that stage_split's item u holds:
// a quarter warp takes 8 nodes of one float4 column
template <int D>
__device__ __forceinline__ int split_node(int u) {
  return (u >> 3) / (D / 4) * 8 + (u & 7);
}
template <int D>
__device__ __forceinline__ int split_quad(int u) {
  return (u >> 3) % (D / 4);
}

// the loads of stage_split: nodes r0 .. r0 + NT - 1 of a [N, D] slice ->
// v, zeros past n
template <int D>
__device__ __forceinline__ void load_split(float4 (&v)[SPLIT_ITER<D>], const float* __restrict__ src,
                                           int r0, int n, int64_t node_stride) {
#pragma unroll
  for (int i = 0; i < SPLIT_ITER<D>; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = split_node<D>(u);
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v[i] = __ldg(reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * node_stride +
                                                   4 * split_quad<D>(u)));
  }
}

// the stores of stage_split: v (from load_split) -> dst split, K-major over
// the features (k-block f / 8, tc::b_offset(node, f % 8)); the quarter
// warp's 16-byte stores hit distinct banks
template <int D>
__device__ __forceinline__ void store_split(float (*dst)[2][TILE], const float4 (&v)[SPLIT_ITER<D>]) {
#pragma unroll
  for (int i = 0; i < SPLIT_ITER<D>; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = split_node<D>(u);
    const int q = split_quad<D>(u);
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

// nodes r0 .. r0 + NT - 1 of a [N, D] slice -> dst split; zeros past n.
// Every load is in flight before the first store.
template <int D>
__device__ __forceinline__ void stage_split(float (*dst)[2][TILE], const float* __restrict__ src,
                                            int r0, int n, int64_t node_stride) {
  float4 v[SPLIT_ITER<D>];
  load_split<D>(v, src, r0, n, node_stride);
  store_split<D>(dst, v);
}

// the A fragment of k-step j of a mix with the features on M, from a tile
// of nodes as they are ([NT][D + 4]): (feature fr + 8 h, node
// 8 j + (lane % 4) + 4 h2), split as it is read
template <int D>
__device__ __forceinline__ void transposed_frag(const float (*raw)[D + 4], int fr, int j,
                                                uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tc::split_tf32(raw[8 * j + tq + 4 * h2][fr + 8 * h], ab[2 * h2 + h], as[2 * h2 + h]);
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

// acc[n, m] = sum_f a[n][f] xm[m][f] over the features of the KS k-steps
// kb .. kb + KS - 1 (8 features each; all of them by default), for the
// warpgroup's 64 rows n of a (as they are, split here) and the 64 nodes m
// of the split tile xm, in chains of at most CH k-steps. acc in the m64n64
// fragment: acc[4 nb + 2 h + e] is (row wg_row() + 8 h, column
// 8 nb + 2 (lane % 4) + e).
template <int D, int KS = D / 8>
__device__ __forceinline__ void score_tile(const float (*a)[D + 4], const float (*xm)[2][TILE],
                                           float (&acc)[32], int kb = 0) {
  constexpr int C = KS < CH ? KS : CH;
  const int r = wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < KS; k += C) {
    const int k0 = kb + k;
    float part[1][32];
    chain<C, 1>(
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
// takes rows wg_row() + 8 w of the tile. Each warpgroup holds a score-sized
// accumulator for all 64 rows and writes the half it does not take to ex.
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

// after a barrier: warpgroup 0's and warpgroup 1's accumulators at the
// thread's row wg_row() + 8 wg and the columns 8 nb + 2 (lane % 4) + e, as
// sv[2 nb + e] and dv[2 nb + e]
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

// SMs of the current card: the persistent kernels run one CTA on each
inline int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace gcn_tc
