// Tile staging shared by the mma.sync flash attention forward and backward
// kernels: the padded shared-memory pitch and a cp.async copy of a block of
// rows.
//
// Included by csrc/flash_attention_{fwd,bwd}.cu (after hopper_mma.cuh,
// whose LOG2E and LN2 those kernels use); kernels/build.py hashes this header
// with each source.

#pragma once

#include "warp_mma.cuh"

namespace {

template <int D>
struct Pitch {
  static constexpr int LD = D + 8;  // rows stay 16-byte aligned, ldmatrix conflict-free
};

// Queue the copy of rows [row0, row0 + ROWS) of a (n, d) row-major bf16
// matrix into a ROWS x D tile with pitch Pitch<D>::LD, zero-filling rows >= n
// and columns >= d. Every one of the block's NT threads takes part.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n, int d,
                                          int tid) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks
  constexpr int TOTAL = ROWS * PER_ROW;
  static_assert(TOTAL % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < TOTAL / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 8;
    const int row = row0 + r;
    const bool ok = row < n && col < d;
    cp_async_16(dst + r * Pitch<D>::LD + col,
                ok ? src + static_cast<long long>(row) * d + col : src, ok);
  }
}

// Copy rows [row0, row0 + ROWS) of a (n, d) row-major f32 matrix into a
// ROWS x d tile with pitch ld, zero-filling rows >= n (plain loads).
template <int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int n,
                                              int d, int ld, int tid) {
  for (int i = tid; i < ROWS * d; i += NT) {
    const int row = row0 + i / d;
    dst[(i / d) * ld + i % d] = row < n ? src[static_cast<long long>(row) * d + i % d] : 0.f;
  }
}

}  // namespace
