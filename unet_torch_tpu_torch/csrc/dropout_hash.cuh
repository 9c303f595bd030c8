// The attention-dropout keep mask, shared by the flash attention forward,
// its backward and the mask probe: the counter hash of
// unet_torch_tpu/kernels/attention.py (_mix32, _dropout_keep).
//
//   base = mix32(seed ^ (bh * 2654435761))
//   keep = mix32((row * nk_p + col) ^ base) >= thr
//
// with mix32 murmur3's 32-bit finaliser and every product taken modulo
// 2**32 (uint32 wraparound, as JAX's uint32 arithmetic). bh is the flat
// batch*head index (`dropout_bh`), row and col the global query and key
// indices, nk_p the key count padded as the JAX package pads it
// (kernels/attention.py dfa_nk_p), thr = min(int(rate * 2**32), 2**32 - 1).
// The mask is a function of (seed, bh, row, col) alone, so every kernel
// regenerates the same bits whatever tiles it walks.
//
// Included by csrc/*.cu; kernels/build.py hashes this header with each
// source.

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The bh a block hashes. A rank that holds a share of the batch and of the
// heads (data and tensor parallel training) launches on its local (b, h) =
// (bh / H, bh % H), which is (b + b_off, h + h_off) of the whole batch of
// h_total heads: hashing that flat index makes the rank's mask its slice of
// the one-process mask. Zero offsets and h_total = H give bh itself.
__device__ __forceinline__ uint32_t dropout_bh(int bh, int H, int b_off, int h_off, int h_total) {
  const uint32_t b = static_cast<uint32_t>(bh / H + b_off);
  return b * static_cast<uint32_t>(h_total) + static_cast<uint32_t>(bh % H + h_off);
}

__device__ __forceinline__ uint32_t dropout_base(uint32_t seed, uint32_t bh) {
  return mix32(seed ^ (bh * 2654435761u));
}

__device__ __forceinline__ bool dropout_keep(uint32_t base, uint32_t row, uint32_t col,
                                             uint32_t nk_p, uint32_t thr) {
  return mix32((row * nk_p + col) ^ base) >= thr;
}

// The same bit from idx = row * nk_p + col and folded = base ^ (base >> 16):
// mix32's first step on idx ^ base is idx ^ (idx >> 16) ^ folded, one
// instruction less a score in the attention kernels' inner loops.
__device__ __forceinline__ uint32_t dropout_fold(uint32_t base) { return base ^ (base >> 16); }

__device__ __forceinline__ bool dropout_keep_idx(uint32_t folded, uint32_t idx, uint32_t thr) {
  uint32_t x = idx ^ (idx >> 16) ^ folded;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thr;
}

}  // namespace
