// Warpgroup-level building blocks of the port's Hopper (sm_90a) attention
// kernels: swizzled shared-memory tiles, wgmma shared-memory descriptors and
// the asynchronous bf16 warpgroup products (wgmma.mma_async, f32
// accumulators) with their fences; mbarriers, TMA tile loads and reduce-adds
// with the host's tensor maps, named barriers, setmaxnreg.
//
// A tile is 64 rows of D bf16 values (D = 64: 128 bytes a row, D = 32: 64
// bytes a row), rows contiguous, base 1024-byte aligned, the 16-byte chunks
// of each row permuted by the 128-byte (D = 64) or 64-byte (D = 32) swizzle:
// what a TMA load with that swizzle writes and a wgmma descriptor with that
// layout reads. One such tile serves a wgmma in two ways:
//   K-major  (desc_kmajor): the rows are the product's M (A operand) or N
//            (B operand) index and D is its depth; a k16 step moves 32 bytes
//            along the row;
//   MN-major (desc_mnmajor, with the instruction's transpose bit): the rows
//            are the depth and D is the product's M or N index (D <= one
//            swizzle atom); a k16 step moves 16 rows.
// So V, Q, dO and K tiles feed both S = Q K^T-like and P V-like products
// without ever being transposed in memory.
//
// The accumulator of an m64nNk16 product puts, for thread t of the warpgroup
// (warp w = t / 32, g = (t % 32) / 4, t4 = t % 4), d[4 j + e] at row
// 16 w + g + 8 (e >> 1), column 8 j + 2 t4 + (e & 1): where mma.sync m16n8k16
// puts c[j][e] for the warp's 16 rows. The register A operand of a k16 step
// is four packed bf16 pairs laid out as mma.sync's A fragment, so the
// accumulators of two adjacent 8-column groups, rounded to bf16, are the A
// operand of the next product.
//
// wgmma is asynchronous: between wgmma_fence() + launch and wgmma_wait<N>() the
// accumulator and register-A values must not be touched; keep_regs() pins
// them across the wait for the compiler.
//
// Included by csrc/flash_attention_{fwd,bwd}.cu (the forward's wgmma kernel
// through csrc/flash_fwd_wgmma.cuh, which csrc/packed2_attention_fwd.cu also
// includes) and, for its wgmma route,
// csrc/fused_conv3x3_bn_relu.cu (4-D TMA loads and stores, the m64n{64,128,
// 256}k16 forms with a K-major A and an MN-major B); kernels/build.py hashes
// this header with each source.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked

#include "warp_mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Swizzled tiles
// ---------------------------------------------------------------------------

template <int D>
struct Swizzle {
  static_assert(D == 32 || D == 64, "tile rows of 64 or 128 bytes");
  static constexpr int ROW_BYTES = D * 2;
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // eight rows
  static constexpr uint64_t LAYOUT = D == 64 ? 1 : 2;  // B128 : B64
  // byte offset of chunk c of row r: address bits [4, 7) (B128) or [4, 6)
  // (B64) are xor-ed with bits [7, 10) or [7, 9)
  __device__ __forceinline__ static int offset(int r, int c) {
    const int x = D == 64 ? (r & 7) : ((r >> 1) & 3);
    return r * ROW_BYTES + ((c ^ x) << 4);
  }
};

template <int ROWS, int D>
__host__ __device__ constexpr int tile_bytes() {
  return ROWS * D * 2;
}

// Shared memory written by st.shared becomes visible to the async proxy,
// through which wgmma and TMA read it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2**x on the exp unit, one instruction (denormal results flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Descriptors
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const void* tile, int lbo_bytes, int sbo_bytes,
                                              uint64_t layout) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (layout << 62);
}

// Rows are M or N, D is the depth. Add kmajor_step() per k16 step.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return make_desc(tile, 16, Swizzle<D>::GROUP_BYTES, Swizzle<D>::LAYOUT);
}
__host__ __device__ constexpr uint64_t kmajor_step() { return 32 >> 4; }

// Rows are the depth, D is M or N (one swizzle atom wide). Add
// mnmajor_step<D>() per k16 step (16 rows).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
  return make_desc(tile, Swizzle<D>::GROUP_BYTES, Swizzle<D>::GROUP_BYTES, Swizzle<D>::LAYOUT);
}
template <int D>
__host__ __device__ constexpr uint64_t mnmajor_step() {
  return (16 * Swizzle<D>::ROW_BYTES) >> 4;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers across a point of the program: the compiler neither moves
// their uses above it nor reuses them before it.
template <int N>
__device__ __forceinline__ void keep_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void keep_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) keep_regs(r[i]);
}

// d (64 x N) = a * b from two shared-memory tiles, one k16 step: with
// TRANS = 0 both tiles are K-major (a 64 x 16, b N x 16: d = a b^T), with
// TRANS = 1 both are MN-major (a 16 x 64, b 16 x N: d = a^T b). ACC adds to d
// instead (d is then read, and must hold values).
#define WGMMA_N64_REGS                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_N32_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
template <bool ACC, int TRANS>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_N64_REGS
        ", %32, %33, p, 1, 1, %35, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_N64_REGS
        ", %32, %33, p, 1, 1, %35, %35;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "r"(0), "n"(TRANS));
  }
}
template <bool ACC, int TRANS>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_N32_REGS
        ", %16, %17, p, 1, 1, %19, %19;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_N32_REGS
        ", %16, %17, p, 1, 1, %19, %19;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(a), "l"(b), "r"(0), "n"(TRANS));
  }
}

// d (64 x 64) += a (64 x 16, registers) * b (16 x 64, MN-major tile)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
}

// d (64 x 32) += a (64 x 16, registers) * b (16 x 32, MN-major tile)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
}

// d (64 x 64) = A B^T over the whole depth D of two K-major tiles (d need
// not be initialised)
template <int D>
__device__ __forceinline__ void wgmma_ss_tile(float (&d)[32], const void* a_tile,
                                              const void* b_tile) {
  const uint64_t a = desc_kmajor<D>(a_tile);
  const uint64_t b = desc_kmajor<D>(b_tile);
  wgmma_ss<false, 0>(d, a, b);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<true, 0>(d, a + kk * kmajor_step(), b + kk * kmajor_step());
}

// d (64 x D) = A^T B over the 64 rows of two MN-major tiles, A 64 x 64 and B
// 64 x D (d need not be initialised)
template <int D>
__device__ __forceinline__ void wgmma_ss_mn_tile(float (&d)[D / 2], const void* a_tile,
                                                 const void* b_tile) {
  const uint64_t a = desc_mnmajor<64>(a_tile);
  const uint64_t b = desc_mnmajor<D>(b_tile);
  wgmma_ss<false, 1>(d, a, b);
#pragma unroll
  for (int kc = 1; kc < 4; ++kc)
    wgmma_ss<true, 1>(d, a + kc * mnmajor_step<64>(), b + kc * mnmajor_step<D>());
}

// d (64 x D) += A B over the 64 rows of an MN-major tile, A (64 x 64) given
// as four k16 register fragments
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[D / 2], const uint32_t (&a)[4][4],
                                              const void* b_tile) {
  const uint64_t b = desc_mnmajor<D>(b_tile);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs(d, a[kc], b + kc * mnmajor_step<D>());
}

// d (64 x N) = a * b (+ d when acc != 0), one k16 step, with a a K-major tile
// (64 rows of the product's M, 16 deep) and b an MN-major operand (16 rows of
// the depth, N wide): the transpose bit on b only. N = 64, 128, 256: b is
// then one, two or four 64-column tiles (desc_mnmajor_wide). The forms of the
// fused conv's wgmma mainloop: the image rows as A, the HWIO weight as b.
#define WGMMA_N128_REGS                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_N256_REGS                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "     \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"
#define WGMMA_D8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D32(i) WGMMA_D8(i), WGMMA_D8(i + 8), WGMMA_D8(i + 16), WGMMA_D8(i + 24)

__device__ __forceinline__ void wgmma_kn(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_N64_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : WGMMA_D32(0)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_kn(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_N128_REGS
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : WGMMA_D32(0), WGMMA_D32(32)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_kn(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_N256_REGS
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : WGMMA_D32(0), WGMMA_D32(32), WGMMA_D32(64), WGMMA_D32(96)
      : "l"(a), "l"(b), "r"(acc));
}

// An MN-major operand wider than one swizzle atom: 64-column tiles of 64
// rows (128-byte rows, 128-byte swizzle) one after the other, 8 KB apart
// (the leading byte offset), 8-row groups 1024 bytes apart (the stride byte
// offset). Add mnmajor_step<64>() per k16 step.
__device__ __forceinline__ uint64_t desc_mnmajor_wide(const void* tile) {
  return make_desc(tile, tile_bytes<64, 64>(), Swizzle<64>::GROUP_BYTES, Swizzle<64>::LAYOUT);
}

// The accumulators of a 64 x 64 product (d[4 j + e]) rounded to bf16 as the
// four k16 A fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16x2(s[8 * kc + 0], s[8 * kc + 1]);
    a[kc][1] = pack_bf16x2(s[8 * kc + 2], s[8 * kc + 3]);
    a[kc][2] = pack_bf16x2(s[8 * kc + 4], s[8 * kc + 5]);
    a[kc][3] = pack_bf16x2(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// ---------------------------------------------------------------------------
// mbarriers, TMA tile loads, named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// After one thread has initialised the block's barriers, before any use.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase of this parity has completed (a fresh
// barrier counts its phase 1 as complete). With -DFLASH_BOUNDED_SPIN a wait
// that never ends traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
#ifdef FLASH_BOUNDED_SPIN
  for (int spins = 0; !done; ++spins) {
    if (spins > (1 << 24)) __trap();
#else
  while (!done) {
#endif
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One thread asks for the box of a 3-D tensor map at (c0, c1, c2), innermost
// first, to be copied into a swizzled tile; the bytes are reported to `bar`.
// Parts of the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One thread asks for a swizzled 64-row f32 tile in shared memory to be added
// into the box of a 3-D tensor map at (c0, c1, c2); parts of the box outside
// the tensor are dropped. The request joins the thread's current bulk group.
__device__ __forceinline__ void tma_reduce_add_3d(const void* map, const void* src, int c0, int c1,
                                                  int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the thread's bulk groups, all but the N most recent, have read their
// shared-memory sources.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until the thread's bulk groups are complete, their writes done.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// As tma_load_3d for a 4-D tensor map, at (c0, c1, c2, c3), innermost first.
// Coordinates may be negative or past the end: those parts arrive as zeros,
// and the barrier is told the whole box's bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One thread asks for a swizzled tile in shared memory to be written into
// the box of a 4-D tensor map at (c0, c1, c2, c3); parts of the box outside
// the tensor are not written. The request joins the thread's current bulk
// group. The tile's writers fence_proxy_async() first.
__device__ __forceinline__ void tma_store_4d(const void* map, const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// bar.sync on one of the block's named barriers 1..15 (__syncthreads is
// barrier 0), for the `count` threads that meet there.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// setmaxnreg: every warp of a warpgroup gives registers up (dec) or takes
// more (inc, waiting until others have given them up); N a multiple of 8.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The 1024-byte aligned start of the block's dynamic shared memory (the
// launch asks for 1024 bytes more than the tiles take).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// The tensor map of a contiguous (bh, n, cols) array whose boxes are swizzled
// 64-row tiles of `box_bh` consecutive batch*heads (one tile after the other
// in shared memory), `box_cols` values wide (128 or 64 bytes): coordinates
// (column, row, bh). cuTensorMapEncodeTiled is fetched through the
// runtime, so no libcuda is linked. The map holds the array's address: it is
// made anew for every launch and handed to the kernel as a __grid_constant__
// parameter.
inline cudaError_t make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                            int elem_bytes, int cols, int box_cols, long long n, long long bh,
                            int box_bh = 1) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * elem_bytes;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {row_bytes, static_cast<cuuint64_t>(n) * row_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), 64,
                             static_cast<cuuint32_t>(box_bh)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * elem_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// (bh, n, D) bf16, boxes of whole rows: the tiles the products read, of
// `box_bh` batch*heads a box.
template <int D>
cudaError_t make_tile_map(CUtensorMap* map, const void* base, long long n, long long bh,
                          int box_bh = 1) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, D, n, bh, box_bh);
}

// (bh, n, cols) f32, boxes of 32 columns (128 bytes): the target of
// tma_reduce_add_3d.
inline cudaError_t make_f32_map(CUtensorMap* map, void* base, int cols, long long n, long long bh) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cols, 32, n, bh);
}

// The tensor map of a contiguous bf16 array of four dimensions, dims[0]
// innermost, whose boxes are box[0] x ... x box[3] values with box[0] = 64
// (128-byte rows, 128-byte swizzle): a box lands as box[1] * box[2] * box[3]
// rows of a K-major tile (tma_load_4d) or is written from one
// (tma_store_4d). A narrower box[0] (32 or 16 values) takes the 64- or
// 32-byte swizzle. Made anew for every launch, as make_map's maps.
inline cudaError_t make_bf16_map_4d(CUtensorMap* map, const void* base, const long long (&dims)[4],
                                    const int (&box)[4],
                                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t size[4], strides[3];
  cuuint32_t box_size[4];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  cuuint64_t stride = 2;
  for (int i = 0; i < 4; ++i) {
    size[i] = static_cast<cuuint64_t>(dims[i]);
    box_size[i] = static_cast<cuuint32_t>(box[i]);
    stride *= size[i];
    if (i < 3) strides[i] = stride;
  }
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              size, strides, box_size, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
