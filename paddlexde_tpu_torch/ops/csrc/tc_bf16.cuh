// The bfloat16 tensor-core pieces of the bfloat16 forward kernels, shared by
// gcn_bf16.cu (K2) and attn_bf16.cu (K4).
//
// wgmma.mma_async m64nNk16 with bfloat16 A and B and a float32 accumulator
// (SASS HGMMA), in its RS form: A from registers, B from shared memory. A
// bfloat16 product is exact in float32, so one product takes the place of
// the three of 3xTF32 (tc_conv.cuh). The tensor cores' float32 accumulation
// is not round-to-nearest, so the callers start a fresh accumulator every
// few k-steps and add it to a float32 sum on the CUDA cores.
//
// B is K-major without swizzle, as tc_conv.cuh's TF32 tiles: core matrices
// of 8 rows (N) x 16 bytes (8 bfloat16 along K), the two of a k16 step 128
// bytes apart, the groups of 8 rows 256 bytes apart, so tc::desc_b describes
// a bfloat16 tile as it does a TF32 one.
//
// A fragment of a thread (rows g = wg_row-style, k-step of 16): register 0
// holds (g, 2 (lane % 4) .. + 1), register 1 (g + 8, the same k), register
// 2 (g, 8 + 2 (lane % 4) .. + 1), register 3 (g + 8, 8 + ...), the lower k
// in the lower half. The m64nN accumulator holds (g + 8 h, 8 nb + 2 (lane %
// 4) + e) at d[4 nb + 2 h + e], so the accumulator of one product is the A
// fragment of the next: k-step j takes d[8 j .. 8 j + 7] in pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_conv.cuh"

namespace tc16 {

// element offset of B element (n, k) in a K-major bfloat16 tile of 16 k
__device__ __forceinline__ int b_offset(int n, int k) {
  return (n / 8) * 128 + (k / 8) * 64 + (n % 8) * 8 + k % 8;
}

// round to bfloat16, nearest even; as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint16_t bits_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two floats rounded to bfloat16: lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)bits_bf16(lo) | ((uint32_t)bits_bf16(hi) << 16);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
__device__ __forceinline__ float from_bf16(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

// x / y rounded to nearest, as the IEEE division gives it, from r = 1 / y
// rounded to nearest (__frcp_rn) and one correction: the quotient x r, its
// exact residual x - q y, and q + residual r (Markstein). Cheaper than the
// division's full sequence where one y divides many x (a softmax row).
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// d (+)= a b on an m64n64k16 tile; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (+)= a b on an m64n128k16 tile; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (the conv pipelines of tc_bf16_conv.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread initialises; fence_barrier_init, then a CTA barrier, before use
__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive (release: this thread's earlier shared-memory accesses are seen by
// whoever waits on the phase)
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from bulk copies before the phase completes
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// this thread's arrival, made once its earlier cp.async copies have landed
__device__ __forceinline__ void barrier_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, counted on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a warpgroup's registers per thread from here on (setmaxnreg; all four
// warps execute it, and the two paths of a specialised kernel never meet
// again)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// m64nNk16 for N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (N == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n64(d, a, b, scale_d);
}

}  // namespace tc16
