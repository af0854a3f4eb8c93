// The temporal conv of the bfloat16 attention kernels on a tile of 16
// (batch, node) rows, shared by attn_bf16.cu (K4 bf16) and attn_bwd_bf16.cu
// (K5 bf16): the bfloat16 weight banks' layout, the chain of one weight
// chunk, and the two pipelines that feed it.
//
//   out[row, t] = sum_{j < K} x[row, t + j - pad_left] W[j]   (zero outside
//   [0, T) of the row's own 12 steps)
//
// on a bfloat16 tile of M = 192 positions, staged in shared memory as
// [M][D + 8], by three warpgroups of 64 positions (wgmma m64nNk16, RS form,
// tc_bf16.cuh: A read from the tile with each tap's shift, B a weight chunk
// in shared memory).
//
// The chain. A weight chunk is 16 input channels x K taps (contiguous in the
// bank); its K k16 products start a fresh accumulator, which is added to a
// float32 sum on the CUDA cores in chunk order 0 .. D/16 - 1, since the
// tensor cores' float32 accumulation is not round-to-nearest. Both pipelines
// keep that chain and that order, so they give the bits of a loop that
// streams the chunks one by one.
//
// Bound: bytes. At PEMS08 (B 32, N 170, D 128) K5 bf16's two conv launches
// move 351 MB (0.105 ms at 3.35 TB/s) for 0.045 ms of products; K4 bf16 117
// MB. Before this design every 16 rows streamed the whole bank (96 KB) from
// L2 in chunks behind two CTA barriers each, and the staging of x ran
// before any product with nothing else in flight. What the two pipelines do
// about it:
//
// - K5's conv stage (conv_half, driven by attn_bwd_bf16_conv_kernel): a
//   persistent CTA per SM holds one job's whole bank in shared memory,
//   loaded once by bulk copies, and walks tiles. A producer warpgroup fills
//   a ring of x tiles while the three consumer warpgroups run the current
//   tile's chains; stages are handed over by mbarriers, with no CTA barrier
//   in the loop. A consumer covers the outputs one half of 64 at a time
//   (32 accumulators and 32 chain partials a thread), storing a half while
//   it runs the next; setmaxnreg gives it 144 registers and the producer,
//   whose 12 16-byte loads a thread are in flight at once, 72.
// - K4's fused kernel (conv_ring): the x tile is its own (the convs run in
//   place between the CUDA-core stages), so the weights stream instead:
//   chunks pass through a ring of RING stages filled by one thread's bulk
//   copies, signalled by mbarriers (full: the bytes landed; empty: all 384
//   threads are done with the stage), and the ring runs on across the
//   kernel's four convs, so the next conv's first chunks land during this
//   conv's tail and the attention core between them. One CTA barrier per
//   conv (the tile is overwritten in place after it), none per chunk. A
//   chunk's two output halves run one after the other into one chain
//   partial: 64 accumulators, 32 partials and the fragments fit the 168
//   registers a thread of a 384-thread CTA without spills.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace tc16 {

constexpr int DH = 16;           // features per head
constexpr int ROWS = 16;         // (batch, node) rows per tile
constexpr int M = ROWS * tc::T;  // 192 positions
constexpr int THREADS = 384;     // three warpgroups of 64 positions
constexpr int KC = 16;           // input channels per weight chunk (one k16 step)
constexpr int RING = 3;          // weight stages of conv_ring

template <int D>
struct Geo {
  static constexpr int H = D / DH;
  static constexpr int S = D + 8;             // tile row stride, bfloat16 elements
  static constexpr int BLK = D * KC;          // elements of one tap's B tile
  static constexpr int CHUNK = tc::K * BLK;   // elements of one weight chunk
  static constexpr int CHUNKS = D / KC;
  static constexpr int BANK = CHUNKS * CHUNK;  // K D^2
};

// element of a bfloat16 bank for W[j][c][f] (tap j, input c, output f)
template <int D>
__device__ __forceinline__ int bank_index(int j, int c, int f) {
  return ((c / KC) * tc::K + j) * Geo<D>::BLK + b_offset(f, c % KC);
}

// the A fragments of chunk ci for the K taps: each read with the tap's
// shift, zero outside the row's T steps (threads 0 .. THREADS - 1)
template <int D>
__device__ __forceinline__ void a_frags(const uint16_t (*xs)[Geo<D>::S], int ci, int padl,
                                        uint32_t (&af)[tc::K][4]) {
  const int pos[2] = {tc::frag_row(), tc::frag_row() + 8};
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < tc::K; ++j) {
    const int shift = j - padl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ts = pos[h] % tc::T + shift;
      const bool ok = pos[h] < M && ts >= 0 && ts < tc::T;
      const uint16_t* src = &xs[ok ? pos[h] + shift : 0][ci * KC + 2 * tq];
      af[j][h] = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      af[j][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }
  }
}

// issue one chain: part = sum over the K taps of af[j] times the B tile at
// taps + j BLK (N outputs), a fresh accumulator; committed, not waited on
template <int D, int N>
__device__ __forceinline__ void chain(float (&part)[N / 2], const uint32_t (&af)[tc::K][4],
                                      const uint16_t* taps) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int j = 0; j < tc::K; ++j)
    wgmma<N>(part, af[j], tc::desc_b(reinterpret_cast<const float*>(taps + j * Geo<D>::BLK)), j > 0);
  tc::wgmma_commit();
}

// after wgmma_wait: the chain's partial into the float32 sum acc[off ..
// off + N / 2) (off a constant after unrolling)
template <int N, int A>
__device__ __forceinline__ void flush(float (&acc)[A], int off, float (&part)[N / 2],
                                      uint32_t (&af)[tc::K][4]) {
#pragma unroll
  for (int j = 0; j < tc::K; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tc::hold(af[j][i]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    tc::hold(part[i]);
    acc[off + i] += part[i];
  }
}

// Both pipelines run a chunk's chain for 64 outputs at a time (wgmma
// m64n64k16): an output's chain is the same K k16 products into a fresh
// accumulator whatever the width of the instruction, so the sums are the
// full-width product's, and one chain partial of 32 registers a thread
// serves both halves.
constexpr int HALF = 64;
// element offset of output 64 h in a B tile (8 groups of 8 outputs, 128
// elements apart); the accumulator of outputs 64 h .. is acc[32 h ..]
constexpr int HALF_OFFSET = (HALF / 8) * 128;

// ---------------------------------------------------------------------------
// K5: a resident bank, one output half at a time
// ---------------------------------------------------------------------------

// acc = outputs [HALF half, HALF half + HALF) of the conv of the staged tile
// xs with the bank w in shared memory (no bias). Only the calling
// warpgroup takes part.
template <int D>
__device__ __forceinline__ void conv_half(const uint16_t (*xs)[Geo<D>::S], const uint16_t* w,
                                          int half, int padl, float (&acc)[HALF / 2]) {
  using G = Geo<D>;
  float part[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int ci = 0; ci < G::CHUNKS; ++ci) {
    uint32_t af[tc::K][4];
    a_frags<D>(xs, ci, padl, af);
    chain<D, HALF>(part, af, w + ci * G::CHUNK + half * HALF_OFFSET);
    tc::wgmma_wait_all();
    flush<HALF>(acc, 0, part, af);
  }
}

// ---------------------------------------------------------------------------
// K4: the weight chunks through a ring across the kernel's convs
// ---------------------------------------------------------------------------

template <int D>
struct WRing {
  uint16_t w[RING][Geo<D>::CHUNK];
  uint64_t full[RING];   // chunk landed (one arrival + its bytes)
  uint64_t empty[RING];  // every thread done with the stage (THREADS arrivals)
};

// thread 0: chunk c (of the contiguous chunks at `chunks`) into stage c %
// RING, once the stage's previous chunk, c - RING, is done with
template <int D>
__device__ __forceinline__ void ring_issue(WRing<D>& r, const uint16_t* __restrict__ chunks, int c) {
  constexpr uint32_t BYTES = 2 * Geo<D>::CHUNK;
  const int st = c % RING;
  if (c >= RING) barrier_wait(&r.empty[st], (c / RING - 1) & 1);
  barrier_expect(&r.full[st], BYTES);
  bulk_copy(r.w[st], chunks + (int64_t)c * Geo<D>::CHUNK, BYTES, &r.full[st]);
}

// thread 0: the ring's barriers, and its first RING - 1 chunks in flight.
// A CTA barrier must follow before any thread uses the ring.
template <int D>
__device__ __forceinline__ void ring_start(WRing<D>& r, const uint16_t* __restrict__ chunks, int total) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < RING; ++st) {
      barrier_init(&r.full[st], 1);
      barrier_init(&r.empty[st], THREADS);
    }
    fence_barrier_init();
    for (int c = 0; c < RING - 1 && c < total; ++c) ring_issue<D>(r, chunks, c);
  }
}

// acc = the conv of the staged tile xs with chunks g0 .. g0 + CHUNKS - 1 of
// the ring's `total` (no bias). Every thread of the CTA calls it, for every
// conv in order; thread 0, after its chain of chunk g, issues chunk g +
// RING - 1 once every thread is done with chunk g - 1. It ends with a CTA
// barrier, after which xs may be overwritten.
template <int D>
__device__ __forceinline__ void conv_ring(const uint16_t (*xs)[Geo<D>::S], WRing<D>& r,
                                          const uint16_t* __restrict__ chunks, int g0, int total,
                                          int padl, float (&acc)[D / 2]) {
  using G = Geo<D>;
  float part[HALF / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int ci = 0; ci < G::CHUNKS; ++ci) {
    const int g = g0 + ci;
    const int st = g % RING;
    uint32_t af[tc::K][4];
    a_frags<D>(xs, ci, padl, af);
    barrier_wait(&r.full[st], (g / RING) & 1);
#pragma unroll
    for (int h = 0; h < D / HALF; ++h) {
      chain<D, HALF>(part, af, r.w[st] + h * HALF_OFFSET);
      tc::wgmma_wait_all();
      flush<HALF>(acc, h * HALF / 2, part, af);
    }
    barrier_arrive(&r.empty[st]);
    // chunk g + RING - 1 into the stage of chunk g - 1
    if (threadIdx.x == 0 && g + RING - 1 < total) ring_issue<D>(r, chunks, g + RING - 1);
    __syncwarp();
  }
  __syncthreads();
}

}  // namespace tc16
