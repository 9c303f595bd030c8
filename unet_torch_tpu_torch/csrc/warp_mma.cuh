// Warp-level building blocks shared by the port's Hopper kernels: cp.async
// copies, ldmatrix fragment loads and the bf16 m16n8k16 tensor-core product
// (mma.sync, f32 accumulators), plus bf16 packing.
//
// Included by each csrc/*.cu; kernels/build.py hashes this header with the
// source, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// 16-byte global -> shared copy that reads the first `bytes` (0 to 16) of
// src and writes zeros for the rest.
__device__ __forceinline__ void cp_async_16_bytes(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
// With pred false it writes zeros and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  cp_async_16_bytes(dst, src, pred ? 16 : 0);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16x16 bf16 A fragment (x4) or two 16x8 B fragments (x4 of a [n][k] tile,
// or x4.trans of a [k][n] tile) from shared memory; each lane passes the
// address of one 16-byte row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
