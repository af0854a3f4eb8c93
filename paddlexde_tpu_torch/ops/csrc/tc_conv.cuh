// The temporal conv of D3STN's attention block on Hopper's tensor cores,
// shared by attn.cu (K4) and attn_bwd.cu (K5), and the TF32 pieces of
// K5's weight-gradient products.
//
//   out[row, t] = bias + sum_{j < K} x[row, t + j - pad_left] W[j]   (zero
//   outside [0, T) of the row's own 12 steps)
//
// over a tile of R whole (batch, node) rows, M = 12 R positions, staged in
// shared memory as [M][D + 4] floats (K4: R = 8, K5: R = 16). Each tap is a [M x D] x [D x D]
// product; the taps add into one accumulator.
//
// 3xTF32. Every float x splits into big = x rounded to TF32 (nearest, ties
// away) and small = x - big, and x w ~ small_x big_w + big_x small_w +
// big_x big_w, the two small terms first (CUTLASS's OpMultiplyAddFastF32).
// small is exact in float32 and the tensor cores read only its top 19 bits,
// a truncation of less than 2^-21 |x|. This keeps float32 accuracy at a
// third of the TF32 rate: 165 TFLOP/s on an H100 against 67 on the CUDA
// cores. Plain TF32 keeps ~3 decimal digits.
//
// The product is wgmma.mma_async m64nDk8 TF32 (SASS HGMMA) in its RS form:
// one warpgroup per 64 positions (at R = 8 the second covers positions
// 64..127, of which 96..127 are padding), A from registers, B from shared
// memory.
// The A fragment is read from the staged tile with the tap's time shift and
// zero fill at the row's edges, and split as it is read. The weights arrive
// split ({big, small}, written once per call by a prep kernel in the order
// of bank_index: K-major core matrices without swizzle) and stream through
// shared memory in chunks of KC = 8 input channels x K taps (cp.async,
// double buffered, 48 KB at D = 128). The tensor cores' float32 accumulation
// is not round-to-nearest: along a chain of 144 products (one conv at
// D = 128) its error grew to ~1e-5 of the result (K5 against float64). So
// each chunk's 9 products (3 taps x 3 terms) start a fresh accumulator,
// which is then added to the running sum on the CUDA cores.
//
// Why wgmma: mma.sync m16n8k8 TF32 (SASS HMMA) with the same tiles reached
// ~100 TFLOP/s of TF32 work on an H100, so three products through it barely
// beat the CUDA cores (K4 0.79 ms against 0.78; wgmma: 0.56).
//
// The weight-gradient kernel of attn_bwd.cu uses the same split, wgmma
// wrappers and B layout (b_offset, desc_b) with its own tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int T = 12;   // time steps of a row
constexpr int K = 3;    // taps
constexpr int KC = 8;   // input channels per weight chunk


// x = big + small exactly; big is x rounded to TF32, nearest with ties away
// from zero (cvt.rna.tf32.f32 for finite x, in two integer operations: 2^12
// added to the magnitude's bits, the 13 low bits cleared)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// 16 bytes, or 16 zero bytes when !full (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// the split weights of one conv at width D
template <int D>
struct Bank {
  static constexpr int BLK = D * KC;           // floats of one B tile: one tap, big or small
  static constexpr int CHUNK = 2 * K * BLK;    // floats of one weight chunk
  static constexpr int CHUNKS = D / KC;
  static constexpr int SIZE = CHUNKS * CHUNK;  // floats of a split bank: 2 K D^2
  static constexpr int STAGES = 2 * CHUNK;     // floats of the two weight stages
};

// a tile of R rows: M positions, one warpgroup per 64 of them
template <int D, int R>
struct Geo {
  static constexpr int M = R * T;
  static constexpr int THREADS = 128 * ((M + 63) / 64);
  static constexpr int S = D + 4;              // tile row stride, floats
  static constexpr int TILE = M * S;           // floats of a tile
};

// float offset of B element (n, k) in a K-major tile of 8 k: core matrices
// of 8 n x 4 k (16-byte rows), the two along k 128 bytes apart, the groups
// of 8 n 256 bytes apart (the layout desc_b describes)
__device__ __forceinline__ int b_offset(int n, int k) {
  return (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4;
}

// Where W[j][c][f] (tap j, input c, output f) goes in a split bank: chunk
// c / KC, tap j, big (term 0) or small (1), then wgmma's K-major core
// matrices without swizzle: 8 outputs x 4 inputs (16-byte rows, 128 bytes),
// the two along the inputs 128 bytes apart, the output groups 256 apart.
template <int D>
__device__ __forceinline__ int64_t bank_index(int j, int c, int f, int term) {
  const int k = c % KC;
  return (((int64_t)(c / KC) * K + j) * 2 + term) * D * KC + b_offset(f, k);
}

template <int D>
__device__ __forceinline__ void put_split(float* __restrict__ bank, int j, int c, int f, float w) {
  uint32_t big, small;
  split_tf32(w, big, small);
  bank[bank_index<D>(j, c, f, 0)] = __uint_as_float(big);
  bank[bank_index<D>(j, c, f, 1)] = __uint_as_float(small);
}

// descriptor of a K-major B tile at `tile` (no swizzle; leading byte
// offset 128 between the core matrices along K, stride 256 between groups
// of 8 rows)
__device__ __forceinline__ uint64_t desc_b(const float* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread (cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep a register's value where it is until here (wgmma reads and writes
// its registers asynchronously, between issue and wait)
__device__ __forceinline__ void hold(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// d (+)= a b on an m64n128k8 tile: a the warp's rows of the A fragment
// (TF32 in registers), b the K-major B tile in shared memory (descriptor);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (+)= a b on an m64n64k8 tile: a the warp's rows of the A fragment
// (TF32 in registers), b the K-major B tile in shared memory (descriptor);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (D == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n64(d, a, b, scale_d);
}

// one weight chunk (contiguous in the split bank) -> a stage
template <int D>
__device__ __forceinline__ void load_chunk(float* stage_buf, const float* __restrict__ bank,
                                           int chunk) {
  constexpr int CHUNK = 2 * K * D * KC;
  const float* src = bank + (int64_t)chunk * CHUNK;
  for (int u = threadIdx.x; u < CHUNK / 4; u += blockDim.x) cp_async16(stage_buf + 4 * u, src + 4 * u);
}

// rows [row0, row0 + R) of src [rows, T, D] -> the tile, zeros past n_rows
// (cp.async, all in flight at once; committed, not waited for)
template <int D, int R>
__device__ __forceinline__ void stage_async(float* xs, const float* __restrict__ src,
                                            int64_t row0, int n_rows) {
  using G = Geo<D, R>;
  const float* base = src + row0 * T * D;
  for (int u = threadIdx.x; u < G::M * (D / 4); u += blockDim.x) {
    const int pos = u / (D / 4);
    const int q = u % (D / 4);
    const bool full = pos < n_rows * T;
    cp_async16_zfill(xs + pos * G::S + 4 * q, base + (full ? pos * D + 4 * q : 0), full);
  }
  cp_async_commit();
}

// stage_async, then wait for this thread's copies (the caller's barrier
// publishes the tile)
template <int D, int R>
__device__ __forceinline__ void stage(float* xs, const float* __restrict__ src, int64_t row0,
                                      int n_rows) {
  stage_async<D, R>(xs, src, row0, n_rows);
  cp_async_wait_all();
}

// a thread's accumulator: the m64nD fragment of its warpgroup
template <int D>
using Acc = float[D / 2];

// the first of a thread's two rows of its warpgroup's m64 tile (the other
// is 8 further)
__device__ __forceinline__ int frag_row() {
  const int tid = threadIdx.x;
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}

// the A fragments of chunk ci's K taps for the positions pos (time steps
// tt) of a thread: a0 (row g, k tq), a1 (g + 8, tq), a2 (g, tq + 4),
// a3 (g + 8, tq + 4), each read with the tap's shift, zero outside the row
template <int D, int R>
__device__ __forceinline__ void conv_a(const float* xs, int ci, int padl, const int (&pos)[2],
                                       const int (&tt)[2], uint32_t (&ab)[K][4],
                                       uint32_t (&as)[K][4]) {
  const int c0 = ci * KC + (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int shift = j - padl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ts = tt[h] + shift;
      const bool ok = pos[h] < Geo<D, R>::M && ts >= 0 && ts < T;
      const float* p = xs + (ok ? pos[h] + shift : 0) * Geo<D, R>::S + c0;
      split_tf32(ok ? p[0] : 0.f, ab[j][h], as[j][h]);
      split_tf32(ok ? p[4] : 0.f, ab[j][2 + h], as[j][2 + h]);
    }
  }
}

// acc = the conv of the staged R-row tile xs with the split bank (no bias).
// Every thread of the CTA calls it; it ends with a CTA barrier, after which
// xs and the weight stages may be overwritten. Up to 256 threads the A
// fragments of the next chunk are read while the tensor cores run this
// chunk's products; that takes 24 more registers, which 384 threads (at
// most 168 registers each) do not have.
template <int D, int R>
__device__ __forceinline__ void conv(const float* xs, const float* __restrict__ bank, float* wsm,
                                     int padl, Acc<D>& acc) {
  using B = Bank<D>;
  constexpr bool OVERLAP = Geo<D, R>::THREADS <= 256;
  const int pos[2] = {frag_row(), frag_row() + 8};
  const int tt[2] = {pos[0] % T, pos[1] % T};
  float part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t ab0[K][4], as0[K][4], ab1[K][4], as1[K][4];

  // one chunk: its 9 products (3 taps x 3 terms) start part afresh; part
  // then adds to acc on the CUDA cores
  auto step = [&](int ci, uint32_t (&ab)[K][4], uint32_t (&as)[K][4], uint32_t (&nab)[K][4],
                  uint32_t (&nas)[K][4]) {
    if (ci + 1 < B::CHUNKS) load_chunk<D>(wsm + ((ci + 1) & 1) * B::CHUNK, bank, ci + 1);
    cp_async_commit();
    cp_async_wait_prev();
    fence_proxy_async();
    __syncthreads();
    if (!OVERLAP) conv_a<D, R>(xs, ci, padl, pos, tt, ab, as);
    const float* stg = wsm + (ci & 1) * B::CHUNK;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) hold(part[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint64_t big = desc_b(stg + 2 * j * B::BLK);
      const uint64_t small = desc_b(stg + (2 * j + 1) * B::BLK);
      wgmma<D>(part, as[j], big, j > 0);
      wgmma<D>(part, ab[j], small, 1);
      wgmma<D>(part, ab[j], big, 1);
    }
    wgmma_commit();
    if (OVERLAP && ci + 1 < B::CHUNKS) conv_a<D, R>(xs, ci + 1, padl, pos, tt, nab, nas);
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hold(ab[j][i]);
        hold(as[j][i]);
      }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      hold(part[i]);
      acc[i] += part[i];
    }
    __syncthreads();
  };

  load_chunk<D>(wsm, bank, 0);
  cp_async_commit();
  if (OVERLAP) conv_a<D, R>(xs, 0, padl, pos, tt, ab0, as0);
  static_assert(B::CHUNKS % 2 == 0, "chunks go in pairs (the two A buffers)");
  for (int ci = 0; ci < B::CHUNKS; ci += 2) {
    if (OVERLAP) {
      step(ci, ab0, as0, ab1, as1);
      step(ci + 1, ab1, as1, ab0, as0);
    } else {
      step(ci, ab0, as0, ab0, as0);
      step(ci + 1, ab0, as0, ab0, as0);
    }
  }
}

// visit every accumulator pair: fn(pos, f, v0, v1) for the outputs (pos, f)
// and (pos, f + 1) of the tile's M positions; bias (nullable) added
template <int D, int M, typename Fn>
__device__ __forceinline__ void epilogue(const Acc<D>& acc, const float* __restrict__ bias,
                                         Fn fn) {
  const int tq = threadIdx.x & 3;
  const int p0 = frag_row();
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int f = nb * 8 + 2 * tq;
    float2 b = make_float2(0.f, 0.f);
    if (bias != nullptr) b = *reinterpret_cast<const float2*>(bias + f);
    if (p0 < M) fn(p0, f, acc[4 * nb] + b.x, acc[4 * nb + 1] + b.y);
    if (p0 + 8 < M) fn(p0 + 8, f, acc[4 * nb + 2] + b.x, acc[4 * nb + 3] + b.y);
  }
}

// acc (+ bias) -> the tile (call after conv's closing barrier)
template <int D, int R>
__device__ __forceinline__ void store_tile(float* xs, const Acc<D>& acc,
                                           const float* __restrict__ bias) {
  epilogue<D, R * T>(acc, bias, [&](int pos, int f, float v0, float v1) {
    *reinterpret_cast<float2*>(xs + pos * (D + 4) + f) = make_float2(v0, v1);
  });
}

// acc (+ bias) -> rows [row0, row0 + n_rows) of out [rows, T, D]
template <int D, int R>
__device__ __forceinline__ void store_global(float* __restrict__ out, int64_t row0, int n_rows,
                                             const Acc<D>& acc, const float* __restrict__ bias) {
  epilogue<D, R * T>(acc, bias, [&](int pos, int f, float v0, float v1) {
    if (pos < n_rows * T)
      *reinterpret_cast<float2*>(out + (row0 * T + pos) * D + f) = make_float2(v0, v1);
  });
}
}  // namespace tc
