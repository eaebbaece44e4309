// Device helpers shared by the int8 tensor-core kernels (binary_gemm.cu,
// binary_conv2d_s1.cu), hand-written for Hopper (sm_90a): 16-byte
// asynchronous copies into shared memory, the mma.sync m16n8k32 s8 x s8 ->
// s32 product, and the signing of raw bf16 / f32 values to int8 bytes in
// registers. Each kernel source is its own library, so the helpers have
// internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s(v) of one value as an int8 byte
template <bool SIGN>
__device__ __forceinline__ uint32_t s8(float v) {
  if (SIGN) return v >= 0.f ? 0x01u : 0xFFu;
  return v > 0.f ? 0x01u : (v < 0.f ? 0xFFu : 0u);
}

// s(v) of four values, one int8 per byte, lowest k first
template <bool SIGN>
__device__ __forceinline__ uint32_t s8x4(float4 f) {
  return s8<SIGN>(f.x) | (s8<SIGN>(f.y) << 8) | (s8<SIGN>(f.z) << 16) |
         (s8<SIGN>(f.w) << 24);
}

// bf16 pairs: a comparison gives 1.0 (0x3F80) or 0.0 per half; bit 0 of
// each half's high byte is the predicate
__device__ __forceinline__ uint32_t high_bits(__nv_bfloat162 lo,
                                              __nv_bfloat162 hi) {
  return __byte_perm(*reinterpret_cast<uint32_t*>(&lo),
                     *reinterpret_cast<uint32_t*>(&hi), 0x7531) &
         0x01010101u;
}

template <bool SIGN>
__device__ __forceinline__ uint32_t s8x4(uint32_t w0, uint32_t w1) {
  const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&w0);
  const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&w1);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  if (SIGN) {
    // per byte 1 -> ~0xFE = 0x01, 0 -> ~0 = 0xFF (no carries)
    return ~(high_bits(__hge2(lo, zero), __hge2(hi, zero)) * 0xFEu);
  }
  const uint32_t gt = high_bits(__hgt2(lo, zero), __hgt2(hi, zero));
  const uint32_t lt = high_bits(__hlt2(lo, zero), __hlt2(hi, zero));
  return gt | (lt * 0xFFu);
}

// s(v) of the eight values at v (16-byte aligned in shared memory) as two
// words of four int8: values 0-3 and 4-7
template <bool SIGN>
__device__ __forceinline__ void s8x8(const float* v, uint32_t& lo,
                                     uint32_t& hi) {
  lo = s8x4<SIGN>(reinterpret_cast<const float4*>(v)[0]);
  hi = s8x4<SIGN>(reinterpret_cast<const float4*>(v)[1]);
}

template <bool SIGN>
__device__ __forceinline__ void s8x8(const __nv_bfloat16* v, uint32_t& lo,
                                     uint32_t& hi) {
  const uint4 raw = *reinterpret_cast<const uint4*>(v);
  lo = s8x4<SIGN>(raw.x, raw.y);
  hi = s8x4<SIGN>(raw.z, raw.w);
}

template <typename T>
__device__ __forceinline__ T zero_value() {
  return T(0.f);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

}  // namespace
