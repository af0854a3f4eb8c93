// The temporal conv of the bfloat16 attention kernels on a tile of 16
// (batch, node) rows, shared by attn_bf16.cu (K4 bf16) and attn_bwd_bf16.cu
// (K5 bf16): the bfloat16 weight banks' layout and the conv itself.
//
//   out[row, t] = sum_{j < K} x[row, t + j - pad_left] W[j]   (zero outside
//   [0, T) of the row's own 12 steps)
//
// on a bfloat16 tile of M = 192 positions, staged in shared memory as
// [M][D + 8], by three warpgroups (wgmma m64nDk16, RS form, tc_bf16.cuh).
// The weights stream through shared memory in chunks of 16 input channels
// x K taps (cp.async, double buffered); each chunk's K products start a
// fresh accumulator that is added to a float32 sum on the CUDA cores, since
// the tensor cores' float32 accumulation is not round-to-nearest.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace tc16 {

constexpr int DH = 16;           // features per head
constexpr int ROWS = 16;         // (batch, node) rows per CTA
constexpr int M = ROWS * tc::T;  // 192 positions
constexpr int THREADS = 384;     // three warpgroups of 64 positions
constexpr int KC = 16;           // input channels per weight chunk (one k16 step)

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

// one weight chunk (contiguous in the bank) -> a stage (cp.async)
template <int D>
__device__ __forceinline__ void load_chunk(uint16_t* stage_buf, const uint16_t* __restrict__ bank,
                                           int chunk) {
  constexpr int CHUNK = Geo<D>::CHUNK;
  const uint16_t* src = bank + (int64_t)chunk * CHUNK;
  for (int u = threadIdx.x; u < CHUNK / 8; u += THREADS) tc::cp_async16(stage_buf + 8 * u, src + 8 * u);
}

// acc = the conv of the staged tile xs with a bfloat16 bank (no bias).
// Every thread of the CTA calls it; it ends with a CTA barrier, after which
// xs and the weight stages may be overwritten.
template <int D>
__device__ __forceinline__ void conv(const uint16_t (*xs)[Geo<D>::S], const uint16_t* __restrict__ bank,
                                     uint16_t (*wsm)[Geo<D>::CHUNK], int padl, float (&acc)[D / 2]) {
  using G = Geo<D>;
  const int pos[2] = {tc::frag_row(), tc::frag_row() + 8};
  const int tt[2] = {pos[0] % tc::T, pos[1] % tc::T};
  const int tq = threadIdx.x & 3;
  float part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  load_chunk<D>(wsm[0], bank, 0);
  tc::cp_async_commit();
  for (int ci = 0; ci < G::CHUNKS; ++ci) {
    if (ci + 1 < G::CHUNKS) load_chunk<D>(wsm[(ci + 1) & 1], bank, ci + 1);
    tc::cp_async_commit();
    tc::cp_async_wait_prev();
    tc::fence_proxy_async();
    __syncthreads();
    // the A fragments of the chunk's K taps: each read with the tap's shift,
    // zero outside the row's T steps
    uint32_t af[tc::K][4];
#pragma unroll
    for (int j = 0; j < tc::K; ++j) {
      const int shift = j - padl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ts = tt[h] + shift;
        const bool ok = pos[h] < M && ts >= 0 && ts < tc::T;
        const uint16_t* src = &xs[ok ? pos[h] + shift : 0][ci * KC + 2 * tq];
        af[j][h] = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
        af[j][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
      }
    }
    const uint16_t* stg = wsm[ci & 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < tc::K; ++j)
      wgmma<D>(part, af[j], tc::desc_b(reinterpret_cast<const float*>(stg + j * G::BLK)), j > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < tc::K; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::hold(af[j][i]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      tc::hold(part[i]);
      acc[i] += part[i];
    }
    __syncthreads();
  }
}

}  // namespace tc16
