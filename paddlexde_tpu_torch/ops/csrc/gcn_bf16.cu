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
// 128. The scores of 64 rows against a node tile of 64 are wgmma products:
// for a float32 x in 3xTF32 (A the rows as they are, split as they are
// read; B the node tile split into K-major TF32 core matrices) in
// gcn_tc.cuh's chains of 8 k-steps, for a bfloat16 x one exact bfloat16
// product (B the node tile in K-major core matrices) in chains of 4
// k16-steps. A row's bf16(p) needs its final maximum and sum, so one online
// pass cannot round where the TPU kernel does. p and a, held in the score
// accumulator's layout, are the A fragment of the mix: bfloat16 wgmma
// against the node tile in bfloat16, K-major over the nodes. Each node
// tile's 4 k-steps start a fresh accumulator, added to the float32 output
// on the CUDA cores in tile order (tc_bf16.cuh).
//
// N <= 192 (every shipped configuration up to PEMS08): gcn_bf16_fwd_kernel,
// a slice per work item. A persistent grid (CTAs from the SM count and the
// occupancy) walks the slices, CTA c taking c, c + grid, ...; a CTA has one
// warpgroup per 64-row tile of the slice (TILES = ceil(N / 64)):
//
// 1. the slice's node tiles come in as they are (cp.async, zeros past N)
//    and stay in shared memory for the item: each tile is read from device
//    memory once, for every row tile and both products. An mbarrier hands
//    them over (every thread's arrival made when its copies land, a phase
//    a slice);
// 2. for each node tile the CUDA cores build from that copy, with 16-byte
//    shared-memory stores, the B of the scores (split TF32 for a float32 x,
//    bfloat16 for a bfloat16 x) into one buffer reused tile after tile;
//    warpgroup w takes the scores of its rows, A its own resident tile, in
//    two halves of 32 columns (wgmma m64n32). The first tile's scores wait
//    in shared memory while the later tiles' are taken;
// 3. at three tiles bf16(gate) (written once a call by
//    gcn_bf16_gate_kernel) comes in by cp.async under the exponentials;
// 4. the row maximum, the exponentials and their sum, in registers, as
//    the TPU kernel's softmax takes them; a = bf16(bf16(p) bf16(gate)),
//    tile 0's exponentials parked while the later tiles' fragments are
//    made;
// 5. then the B of the mix of every tile is built from the resident
//    copies, which are then free: the next slice's copies go out under
//    this slice's mix, in passes of 32 features (wgmma m64n32k16), each
//    pass's node tiles in order into the float32 output, which goes out
//    rounded.
//
// Halves and passes run the same chains on fewer columns: every output
// element is the one the parent kernel (one warpgroup per 64 rows, each
// node tile staged twice from device memory) computed, bit for bit. At
// three tiles 384 threads have 168 registers each, and a row's 96 scores
// must wait for its sum: tile 0's wait in shared memory while the others
// are taken and turned into fragments, and the wgmma descriptors are
// rebuilt per chain from an address the compiler cannot hoist (desc_of),
// since descriptors hoisted out of the slice loop each held a register
// pair; each of these spilled.
//
// Larger N: gcn_bf16_fwd_kernel_two_pass, one CTA of one warpgroup per
// (64 rows, t, b), two passes over the node tiles (staged from device
// memory each time), the first for each row's running maximum and sum of
// exp, the second takes the scores again: 6 N^2 D products where the TPU
// kernel does 4.
//
// Bound: operations (4 N^2 D per slice on the tensor cores, in 3xTF32 for
// the scores of a float32 x, and ~5 N^2 on the CUDA cores) against N D
// elements read and written. Shared memory of the slice kernel at D = 128
// and three tiles: 222 KB for a float32 x (the resident tiles 99 KB, the
// scores' B or the gate 75 KB, the mix's B 48 KB), 174 KB for a bfloat16
// x; one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gcn_tc.cuh"
#include "tc_bf16.cuh"

namespace {

constexpr int NT = gcn_tc::NT;  // nodes per tile, rows per warpgroup
constexpr int CH16 = 4;         // bfloat16 k-steps per score chain (64 products)
constexpr int MIX_N = 32;       // features per pass of the slice kernel's mix
constexpr int MAX_TILES = 3;    // node tiles of a slice kept resident (N <= 192)

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

// d (+)= a b on an m64n32k8 TF32 tile (half the columns of gcn_tc.cuh's
// m64n64 score products)
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d = a b, the first product of a chain: d is written, not read (an
// accumulator left undefined before a "+f" operand miscompiled)
__device__ __forceinline__ void wgmma_tf32_n32_first(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// d (+)= a b on an m64n32k16 bfloat16 tile; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// tc::desc_b of the B tile at p, from an address the compiler cannot hoist
// out of the slice loop: the descriptors of every k-step held across slices
// would each take a register pair. The k-steps of a chain add their offsets
// (bytes / 16) to it.
__device__ __forceinline__ uint64_t desc_of(const void* p) {
  uint32_t a = tc16::smem_u32(p);
  asm volatile("" : "+r"(a));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// the A fragments of the mix for node tile m0: a = bf16(bf16(p) bf16(gate))
// with p = e / sum * scale2, e in the m64n64 fragment (0 past n);
// gate_pair(h, col, g) gives the gate at the thread's row h and columns col,
// col + 1 (a column past n reads column n - 1, where p is 0)
template <typename GatePair>
__device__ __forceinline__ void mix_operand(const float (&e)[32], const float (&sum)[2],
                                            float scale2, GatePair gate_pair, int m0,
                                            uint32_t (&af)[NT / 16][4]) {
  const int tq = threadIdx.x & 3;
  const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float g[2];
      gate_pair(h, m0 + 8 * nb + 2 * tq, g);
      float a[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float p = tc16::div_rn(e[4 * nb + 2 * h + k], sum[h], rsum[h]) * scale2;
        a[k] = tc16::round_bf16(tc16::round_bf16(p) * tc16::round_bf16(g[k]));
      }
      af[nb / 2][(nb % 2) * 2 + h] = tc16::pack_bf16(a[0], a[1]);
      // a pair at a time: bounds the roundings in flight at once (the
      // registers at three warpgroups)
      tc::hold(af[nb / 2][(nb % 2) * 2 + h]);
    }
}

// a column of the m64n64 fragment: acc[4 nb + 2 h + k] is (row r + 8 h,
// column 8 nb + 2 (lane % 4) + k) of the tile
__device__ __forceinline__ int col_of(int m0, int i) {
  return m0 + 8 * (i / 4) + 2 * (threadIdx.x & 3) + i % 2;
}

// the scores of node tile m0 scaled by scale1, and each row's maximum over
// the columns inside n
__device__ __forceinline__ void scale_max(float (&acc)[32], int m0, int n, float scale1,
                                          float (&row_max)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] *= scale1;
    if (col_of(m0, i) < n) row_max[(i / 2) % 2] = fmaxf(row_max[(i / 2) % 2], acc[i]);
  }
}

// ---------------------------------------------------------------------------
// N <= 192: the slice kernel
// ---------------------------------------------------------------------------

// At three resident tiles the kernel's shared memory leaves ~30 KB of L1,
// less than the gate, and the gate's loads would wait on L2 one by one. So
// bf16(gate) is staged: gcn_bf16_gate_kernel writes it once a call, [NP][NP]
// with NP = 64 TILES and rows and columns past n reading row and column
// n - 1, and each slice copies it into shared memory (rows of NP + 8: the 8
// rows of a quarter warp's 4-byte reads 4 banks apart) under its
// exponentials. Up to two tiles the gate stays in L1 and is read from
// device memory.
template <int TILES>
constexpr int NP = NT * TILES;
template <int TILES>
constexpr bool STAGED_GATE = TILES == MAX_TILES;

// The B of the mix is built after the mix's A fragments; until then its
// buffer holds tile 0's scores while the later tiles' are taken, and its
// exponentials while the later tiles' fragments are made (park), which
// keeps a thread within 168 registers at three warpgroups.
template <int D, int TILES>
union MixOrPark {
  uint16_t mix[TILES][NT / 16][D * 16];  // every node tile in bfloat16: B of the mix
  float park[32][128 * TILES];           // tile 0's scores or exponentials, a column a thread
};

template <int D, bool XB, int TILES>
struct SliceSmem;

// float32 x
template <int D, int TILES>
struct SliceSmem<D, false, TILES> {
  float raw[TILES][NT][D + 4];                   // the slice's node tiles, as they are
  union {
    float split[D / 8][2][gcn_tc::TILE];         // one node tile split: B of the scores
    uint16_t gate[NP<TILES>][NP<TILES> + 8];     // bf16(gate), after the scores
  } u;
  MixOrPark<D, TILES> m;
  uint64_t full, gate_full;                      // the tiles / the gate have landed
};

// bfloat16 x
template <int D, int TILES>
struct SliceSmem<D, true, TILES> {
  uint16_t raw[TILES][NT][D + 8];
  union {
    uint16_t score[D / 16][NT * 16];             // one node tile, K-major over the features
    uint16_t gate[NP<TILES>][NP<TILES> + 8];
  } u;
  MixOrPark<D, TILES> m;
  uint64_t full, gate_full;
};

// the slice's TILES * NT rows (node stride `stride` elements) -> raw as they
// are, zeros past n; then this thread's arrival on `full`, made when its
// copies land
template <int D, int CT, typename T, int S>
__device__ __forceinline__ void fill_slice(T (*raw)[S], const T* __restrict__ src, int rows, int n,
                                           int64_t stride, uint64_t* full) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll 1
  for (int u = threadIdx.x; u < rows * (D / V); u += CT) {
    const int r = u / (D / V);
    const int q = u % (D / V);
    const bool ok = r < n;
    tc::cp_async16_zfill(&raw[r][V * q], src + (ok ? (int64_t)r * stride + V * q : 0), ok);
  }
  tc16::barrier_arrive_cp_async(full);
}

// bf16(gate) [NP][NP] -> its shared-memory rows, then this thread's arrival
template <int CT, int NPT>
__device__ __forceinline__ void fill_gate(uint16_t (*dst)[NPT + 8], const uint16_t* __restrict__ src,
                                          uint64_t* full) {
#pragma unroll 1
  for (int u = threadIdx.x; u < NPT * (NPT / 8); u += CT) {
    const int r = u / (NPT / 8);
    const int q = u % (NPT / 8);
    tc::cp_async16(&dst[r][8 * q], src + r * NPT + 8 * q);
  }
  tc16::barrier_arrive_cp_async(full);
}

// a resident float32 node tile -> B of the scores split (gcn_tc.cuh's
// layout: k-block f / 8, tc::b_offset(node, f % 8)); a quarter warp takes 8
// nodes of one float4 column, so its 16-byte loads and stores hit distinct
// banks
template <int D, int CT>
__device__ __forceinline__ void split_from(float (*dst)[2][gcn_tc::TILE],
                                           const float (*raw)[D + 4]) {
#pragma unroll 1
  for (int u = threadIdx.x; u < NT * (D / 4); u += CT) {
    const int r = (u >> 3) / (D / 4) * 8 + (u & 7);
    const int q = (u >> 3) % (D / 4);
    const float4 v = *reinterpret_cast<const float4*>(&raw[r][4 * q]);
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

// a resident bfloat16 node tile -> B of the scores: K-major over the
// features (k-block f / 16, tc16::b_offset(node, f % 16))
template <int D, int CT>
__device__ __forceinline__ void score16_from(uint16_t (*dst)[NT * 16],
                                             const uint16_t (*raw)[D + 8]) {
#pragma unroll 1
  for (int u = threadIdx.x; u < NT * (D / 8); u += CT) {
    const int r = (u >> 3) / (D / 8) * 8 + (u & 7);
    const int q = (u >> 3) % (D / 8);
    *reinterpret_cast<uint4*>(&dst[q / 2][tc16::b_offset(r, (8 * q) % 16)]) =
        *reinterpret_cast<const uint4*>(&raw[r][8 * q]);
  }
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) { return tc16::pack_bf16(lo, hi); }
__device__ __forceinline__ uint32_t pack_pair(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// a resident node tile -> B of the mix in bfloat16: K-major over the nodes
// (k-block m / 16, tc16::b_offset(feature, m % 16)); a thread writes the
// 16-byte row of one feature and 8 nodes, a warp's loads of a node are 32
// consecutive features. The rows past n are zeros already.
template <int D, int CT, typename T, int S>
__device__ __forceinline__ void mix_from(uint16_t (*dst)[D * 16], const T (*raw)[S]) {
#pragma unroll 1
  for (int u = threadIdx.x; u < (NT / 8) * D; u += CT) {
    const int f = u % D;
    const int c = u / D;  // nodes 8 c .. 8 c + 7 of the tile
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = pack_pair(raw[8 * c + 2 * k][f], raw[8 * c + 2 * k + 1][f]);
    *reinterpret_cast<uint4*>(&dst[c / 2][tc16::b_offset(f, (8 * c) % 16)]) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// acc = columns 32 c .. 32 c + 31 of gcn_tc::score_tile's scores (the
// warpgroup's rows of a, split as they are read, against the split node
// tile xm), in its chains of at most CH k-steps of 3 products each, the
// same products in the same order on half the columns: acc[i] is the
// m64n64 accumulator's element 16 c + i
template <int D>
__device__ __forceinline__ void score_half_tf32(const float (*a)[D + 4], const float (*xm)[2][gcn_tc::TILE],
                                                int c, float (&acc)[16]) {
  constexpr int KS = D / 8, C = KS < gcn_tc::CH ? KS : gcn_tc::CH;
  const int r = gcn_tc::wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += C) {
    float part[16];
    uint32_t ab[2][4], as[2][4];
    const uint64_t first = desc_of(xm[k0][0] + 256 * c);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int buf = j & 1;
      if (j >= 2) {  // k-step j - 2 read this buffer
        gcn_tc::wgmma_wait_one();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::hold(ab[buf][i]);
          tc::hold(as[buf][i]);
        }
      }
      const int col = (k0 + j) * 8 + tq;
      tc::split_tf32(a[r][col], ab[buf][0], as[buf][0]);
      tc::split_tf32(a[r + 8][col], ab[buf][1], as[buf][1]);
      tc::split_tf32(a[r][col + 4], ab[buf][2], as[buf][2]);
      tc::split_tf32(a[r + 8][col + 4], ab[buf][3], as[buf][3]);
      tc::wgmma_fence();
      // k-block k0 + j, big then small, nodes 32 c ..: 4 groups of 8 further
      const uint64_t big = first + (uint64_t)(j * 2 * gcn_tc::TILE * 4 / 16);
      const uint64_t small = big + (uint64_t)(gcn_tc::TILE * 4 / 16);
      if (j == 0)
        wgmma_tf32_n32_first(part, as[buf], big);
      else
        wgmma_tf32_n32(part, as[buf], big);
      wgmma_tf32_n32(part, ab[buf], small);
      wgmma_tf32_n32(part, ab[buf], big);
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
    for (int i = 0; i < 16; ++i) {
      tc::hold(part[i]);
      acc[i] += part[i];
    }
  }
}

// acc = columns 32 c .. 32 c + 31 of score16's scores, its chains of CH16
// k-steps on half the columns
template <int D>
__device__ __forceinline__ void score_half16(const uint16_t (*a)[D + 8], const uint16_t (*xs)[NT * 16],
                                             int c, float (&acc)[16]) {
  constexpr int KS = D / 16;
  const int r = gcn_tc::wg_row();
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += CH16) {
    // each k-step's fragment read just before its product
    uint32_t af[CH16][4];
    float part[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) part[i] = 0.f;
    const uint64_t first = desc_of(xs[k0] + 512 * c);  // nodes 32 c ..
#pragma unroll
    for (int j = 0; j < CH16; ++j) {
      const int col = (k0 + j) * 16 + 2 * tq;
      af[j][0] = *reinterpret_cast<const uint32_t*>(&a[r][col]);
      af[j][1] = *reinterpret_cast<const uint32_t*>(&a[r + 8][col]);
      af[j][2] = *reinterpret_cast<const uint32_t*>(&a[r][col + 8]);
      af[j][3] = *reinterpret_cast<const uint32_t*>(&a[r + 8][col + 8]);
      tc::wgmma_fence();
      wgmma_bf16_n32(part, af[j], first + (uint64_t)(j * NT * 16 * 2 / 16), j > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < CH16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::hold(af[j][i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      tc::hold(part[i]);
      acc[i] += part[i];
    }
  }
}

// the scores of the staged node tile for the warpgroup's rows, into acc in
// two halves of 32 columns
template <int D, bool XB, int TILES>
__device__ __forceinline__ void slice_scores(const SliceSmem<D, XB, TILES>& s, int w,
                                             float (&acc)[32]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float half[16];
    if constexpr (XB)
      score_half16<D>(s.raw[w], s.u.score, c, half);
    else
      score_half_tf32<D>(s.raw[w], s.u.split, c, half);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[16 * c + i] = half[i];
  }
}

// every slice (b, t) of x, persistent: CTA blockIdx.x takes slices
// blockIdx.x, + gridDim.x, ... (none left out, none taken twice:
// tests/test_torch_gcn_bf16_ring.py); warpgroup w takes rows 64 w .. 64 w +
// 63 of each
template <int D, bool XB, int TILES>
__device__ __forceinline__ void slice_items(const void* __restrict__ xv,
                                            const float* __restrict__ gate,
                                            const uint16_t* __restrict__ gate16,
                                            uint16_t* __restrict__ y, int n, int t_len,
                                            int slices, float scale1, float scale2) {
  using T = std::conditional_t<XB, uint16_t, float>;
  constexpr int CT = 128 * TILES;
  constexpr int S = XB ? D + 8 : D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SliceSmem<D, XB, TILES>& s = *reinterpret_cast<SliceSmem<D, XB, TILES>*>(smem_raw);
  T (*rows)[S] = &s.raw[0][0];
  const int w = threadIdx.x / 128;
  const int r = gcn_tc::wg_row();
  const int tq = threadIdx.x & 3;
  const int64_t stride = (int64_t)t_len * D;
  auto offset = [&](int bt) { return ((int64_t)(bt / t_len) * n * t_len + bt % t_len) * D; };
  const float* const grow[2] = {gate + (int64_t)min(w * NT + r, n - 1) * n,
                                gate + (int64_t)min(w * NT + r + 8, n - 1) * n};

  if (threadIdx.x == 0) {
    tc16::barrier_init(&s.full, CT);
    tc16::barrier_init(&s.gate_full, CT);
    tc16::fence_barrier_init();
  }
  __syncthreads();
  if ((int)blockIdx.x < slices)
    fill_slice<D, CT>(rows, reinterpret_cast<const T*>(xv) + offset(blockIdx.x), TILES * NT, n,
                      stride, &s.full);

#pragma unroll 1
  for (int bt = blockIdx.x, k = 0; bt < slices; bt += gridDim.x, ++k) {
    tc16::barrier_wait(&s.full, k & 1);

    // the scores of every node tile, then each row's maximum
    float e[TILES][32];
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    auto park = [&](bool back) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& slot = s.m.park[i][threadIdx.x];
        if (back)
          e[0][i] = slot;
        else
          slot = e[0][i];
      }
    };
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      if constexpr (XB)
        score16_from<D, CT>(s.u.score, s.raw[t]);
      else
        split_from<D, CT>(s.u.split, s.raw[t]);
      tc::fence_proxy_async();
      __syncthreads();
      slice_scores(s, w, e[t]);
      // tile 0's scores are parked as they are and scaled when they come
      // back (the maximum does not depend on the order): scaled as they
      // were parked, under the next chains, they spilled
      if (TILES > 1 && t == 0)
        park(false);
      else
        scale_max(e[t], t * NT, n, scale1, row_max);
      __syncthreads();  // the scores' B buffer is free
    }
    // the gate lands under the exponentials
    if constexpr (STAGED_GATE<TILES>) fill_gate<CT, NP<TILES>>(s.u.gate, gate16, &s.gate_full);
    if (TILES > 1) {
      park(true);
      scale_max(e[0], 0, n, scale1, row_max);
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
    uint32_t af[TILES][NT / 16][4];
    if constexpr (STAGED_GATE<TILES>) tc16::barrier_wait(&s.gate_full, k & 1);
    const uint16_t* grow16 = s.u.gate[w * NT + r];
    auto gate_pair = [&](int h, int col, float (&g)[2]) {
      if constexpr (STAGED_GATE<TILES>) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(grow16 + 8 * h * (NP<TILES> + 8) + col);
        g[0] = tc16::lo_bf16(v);
        g[1] = tc16::hi_bf16(v);
      } else {
        g[0] = __ldg(grow[h] + min(col, n - 1));
        g[1] = __ldg(grow[h] + min(col + 1, n - 1));
      }
    };
    // the fragments of tile 0 last, its exponentials parked meanwhile
    if (TILES > 1) park(false);
#pragma unroll
    for (int t = TILES - 1; t > 0; --t) mix_operand(e[t], row_sum, scale2, gate_pair, t * NT, af[t]);
    if (TILES > 1) park(true);
    mix_operand(e[0], row_sum, scale2, gate_pair, 0, af[0]);
    __syncthreads();  // the parked values are free
    // the B of the mix; then the resident tiles are free, and the next
    // slice's tiles land under this one's mix
#pragma unroll
    for (int t = 0; t < TILES; ++t) mix_from<D, CT>(s.m.mix[t], s.raw[t]);
    tc::fence_proxy_async();
    __syncthreads();
    if (bt + (int)gridDim.x < slices)
      fill_slice<D, CT>(rows, reinterpret_cast<const T*>(xv) + offset(bt + gridDim.x), TILES * NT,
                        n, stride, &s.full);

    // y = bf16(a @ bf16(X)), MIX_N features at a time
    uint16_t* yb = y + offset(bt);
#pragma unroll
    for (int hf = 0; hf < D / MIX_N; ++hf) {
      float out[MIX_N / 2];
#pragma unroll
      for (int i = 0; i < MIX_N / 2; ++i) out[i] = 0.f;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        float part[MIX_N / 2];
#pragma unroll
        for (int i = 0; i < MIX_N / 2; ++i) part[i] = 0.f;
        const uint64_t first = desc_of(&s.m.mix[t][0][hf * MIX_N * 16]);
        tc::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NT / 16; ++j)
          wgmma_bf16_n32(part, af[t][j], first + (uint64_t)(j * D * 16 * 2 / 16), j > 0);
        tc::wgmma_commit();
        tc::wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < NT / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) tc::hold(af[t][j][i]);
#pragma unroll
        for (int i = 0; i < MIX_N / 2; ++i) {
          tc::hold(part[i]);
          out[i] += part[i];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w * NT + r + 8 * h;
        if (row >= n) continue;
#pragma unroll
        for (int nb = 0; nb < MIX_N / 8; ++nb)
          *reinterpret_cast<uint32_t*>(yb + (int64_t)row * stride + hf * MIX_N + 8 * nb + 2 * tq) =
              tc16::pack_bf16(out[4 * nb + 2 * h], out[4 * nb + 2 * h + 1]);
      }
    }
    __syncthreads();  // the mix's B tiles and the gate are free
  }
}

// bf16(gate) [np][np] for the slice kernel: rows and columns past n read
// row and column n - 1, as the two-pass kernel's loads do
__global__ void __launch_bounds__(256)
gcn_bf16_gate_kernel(const float* __restrict__ gate, uint16_t* __restrict__ gate16, int n,
                     int np) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= np * (np / 2)) return;
  const int r = i / (np / 2);
  const int c = 2 * (i % (np / 2));
  const float* row = gate + (int64_t)min(r, n - 1) * n;
  *reinterpret_cast<uint32_t*>(gate16 + r * np + c) =
      tc16::pack_bf16(__ldg(row + min(c, n - 1)), __ldg(row + min(c + 1, n - 1)));
}

// ---------------------------------------------------------------------------
// N > 192: two passes, one CTA of one warpgroup per (64 rows, t, b)
// ---------------------------------------------------------------------------

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
  for (int u = threadIdx.x; u < NT * (D / V); u += 128) {
    const int r = u / (D / V);
    const int q = u % (D / V);
    const bool full = r0 + r < n;
    tc::cp_async16_zfill(&dst[r][V * q], src + (full ? (int64_t)(r0 + r) * stride + V * q : 0),
                         full);
  }
  tc::cp_async_commit();
}

// float32 node tile m0 .. m0 + NT - 1 -> split TF32 tile, as split_from
template <int D>
__device__ __forceinline__ void stage_split(float (*dst)[2][gcn_tc::TILE],
                                            const float* __restrict__ src, int m0, int n,
                                            int64_t stride) {
  constexpr int ITER = NT * (D / 4) / 128;
#pragma unroll 4
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * 128;
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

// bfloat16 node tile -> B of the scores, as score16_from
template <int D>
__device__ __forceinline__ void stage_score16(uint16_t (*dst)[NT * 16],
                                              const uint16_t* __restrict__ src, int m0, int n,
                                              int64_t stride) {
  constexpr int ITER = NT * (D / 8) / 128;
#pragma unroll 4
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * 128;
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

// node tile -> B of the mix in bfloat16, as mix_from, from device memory
template <int D, typename T>
__device__ __forceinline__ void stage_mix(uint16_t (*dst)[D * 16], const T* __restrict__ src,
                                          int m0, int n, int64_t stride) {
  constexpr int ITER = (NT / 8) * D / 128;
#pragma unroll 2
  for (int i = 0; i < ITER; ++i) {
    const int u = threadIdx.x + i * 128;
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

// any N, two passes over the node tiles: one CTA of one warpgroup per work
// item (64 rows n, t, b)
template <int D, bool XB>
__global__ void __launch_bounds__(128)
gcn_bf16_fwd_kernel_two_pass(const void* __restrict__ xv, const float* __restrict__ gate,
                             uint16_t* __restrict__ y, int n, int t_len, float scale1,
                             float scale2) {
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
  auto gate_pair = [&](int h, int col, float (&g)[2]) {
    g[0] = __ldg(grow[h] + min(col, n - 1));
    g[1] = __ldg(grow[h] + min(col + 1, n - 1));
  };

  stage_rows<D>(s.xn, xs, n0, n, stride);
  float out[D / 2];  // Y [row, feature] in the m64nD fragment
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
    mix_operand(acc, row_sum, scale2, gate_pair, m0, af);
    mix_tile<D, XB>(s, xs, m0, n, stride, af, out);
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

// N <= 64 TILES: the slice kernel, TILES warpgroups, one slice at a time
// and every score of it in registers (at TILES = 1 three CTAs share an SM)
template <int D, bool XB, int TILES>
__global__ void __launch_bounds__(128 * TILES, TILES == 1 ? 3 : 1)
gcn_bf16_fwd_kernel(const void* __restrict__ xv, const float* __restrict__ gate,
                    const uint16_t* __restrict__ gate16, uint16_t* __restrict__ y, int n,
                    int t_len, int slices, float scale1, float scale2) {
  slice_items<D, XB, TILES>(xv, gate, gate16, y, n, t_len, slices, scale1, scale2);
}

// TILES > 0: bf16(gate) into gate16 (NP elements squared), then the slice
// kernel on a persistent grid; TILES == 0: the two-pass kernel
template <int D, bool XB, int TILES>
int launch(const void* x, const float* gate, uint16_t* gate16, uint16_t* y, int b, int n,
           int t_len, float scale1, float scale2, cudaStream_t stream) {
  const int64_t slices = (int64_t)b * t_len;
  if constexpr (TILES == 0) {
    auto kernel = gcn_bf16_fwd_kernel_two_pass<D, XB>;
    constexpr int smem = (int)sizeof(Smem<D, XB>);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t items = slices * ((n + NT - 1) / NT);
    if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)items, 128, smem, stream>>>(x, gate, y, n, t_len, scale1, scale2);
  } else {
    auto kernel = gcn_bf16_fwd_kernel<D, XB, TILES>;
    constexpr int smem = (int)sizeof(SliceSmem<D, XB, TILES>);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * TILES, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t grid = std::min<int64_t>(slices, (int64_t)gcn_tc::sm_count() * per_sm);
    if constexpr (STAGED_GATE<TILES>) {
      constexpr int pairs = NP<TILES> * NP<TILES> / 2;
      gcn_bf16_gate_kernel<<<(pairs + 255) / 256, 256, 0, stream>>>(gate, gate16, n, NP<TILES>);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)grid, 128 * TILES, smem, stream>>>(x, gate, gate16, y, n, t_len,
                                                         (int)slices, scale1, scale2);
  }
  return (int)cudaGetLastError();
}

// up to MAX_TILES node tiles (N <= 192: every shipped configuration up to
// PEMS08) the slice kernel, past them two passes
template <int D, bool XB>
int dispatch(const void* x, const float* gate, uint16_t* gate16, uint16_t* y, int b, int n,
             int t_len, float scale1, float scale2, cudaStream_t stream) {
  static_assert(MAX_TILES == 3, "one case a resident tile count");
  switch ((n + NT - 1) / NT) {
    case 1: return launch<D, XB, 1>(x, gate, gate16, y, b, n, t_len, scale1, scale2, stream);
    case 2: return launch<D, XB, 2>(x, gate, gate16, y, b, n, t_len, scale1, scale2, stream);
    case 3: return launch<D, XB, 3>(x, gate, gate16, y, b, n, t_len, scale1, scale2, stream);
    default: return launch<D, XB, 0>(x, gate, gate16, y, b, n, t_len, scale1, scale2, stream);
  }
}

}  // namespace

// bfloat16 elements of the scratch that pxt_gcn_fwd_bf16 takes for n nodes
// (the slice kernel's bf16(gate) at three resident tiles; else none)
extern "C" int64_t pxt_gcn_fwd_bf16_scratch(int n) {
  return (n + NT - 1) / NT == MAX_TILES ? (int64_t)NP<MAX_TILES> * NP<MAX_TILES> : 0;
}

// x [b, n, t_len, d] float32 (x_bf16 = 0) or bfloat16 (1), gate [n, n]
// float32, scratch (pxt_gcn_fwd_bf16_scratch(n) elements), y [b, n, t_len,
// d] bfloat16; d = 64 or 128
extern "C" int pxt_gcn_fwd_bf16(const void* x, const void* gate, void* scratch, void* y, int b,
                                int n, int t_len, int d, int x_bf16, float scale1, float scale2,
                                void* stream) {
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  if ((int64_t)b * n * t_len == 0) return 0;
  if ((int64_t)b * t_len > INT32_MAX) return (int)cudaErrorInvalidValue;
  const float* g = (const float*)gate;
  uint16_t* g16 = (uint16_t*)scratch;
  uint16_t* yb = (uint16_t*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return x_bf16 ? dispatch<128, true>(x, g, g16, yb, b, n, t_len, scale1, scale2, s)
                  : dispatch<128, false>(x, g, g16, yb, b, n, t_len, scale1, scale2, s);
  return x_bf16 ? dispatch<64, true>(x, g, g16, yb, b, n, t_len, scale1, scale2, s)
                : dispatch<64, false>(x, g, g16, yb, b, n, t_len, scale1, scale2, s);
}

extern "C" const char* pxt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
