// The attention-dropout keep mask as a (B*H, Nq, Nk) uint8 array of 0/1,
// written from the same device function (dropout_hash.cuh) that the flash
// attention forward and backward apply in registers.
//
// Replaces the mask-dump kernel of unet_torch_tpu/benchmarks/tpu_dfa_check.py
// (dump_hw_mask), which wrote the TPU kernel's keep bits so that they could be
// held against a plain oracle on silicon. Here the probe's bits are held,
// bit for bit, against the plain PyTorch hash (kernels/attention.py
// dropout_keep). Each element goes through `dropout_keep_idx`, the folded
// form (idx = row * nk_p + col against base ^ (base >> 16)) that the
// attention kernels run in their inner loops, so the probe checks the very
// arithmetic it exists to check.
//
// What bounds it on an H100: the hash's integer instructions. At the ViT's
// (96, 1024, 1024) the 100.7 M bytes written take 0.030 ms at 3.35 TB/s,
// while about a dozen integer instructions an element (two multiplies,
// shifts, three-way xors, the compare and the byte's packing) at 64 a clock
// an SM take more than twice that. So nothing is spent that is not the hash:
//   * a block takes one bh (blockIdx.y, looping where BH passes the grid's
//     y limit) and a contiguous run of THREADS * ITEMS items of 16 columns
//     of a row; `dropout_base` and `dropout_fold` are computed once per bh,
//     each item's row and chunk once per thread (one 32-bit division) and
//     stepped by constants the host computes, and each element's index is
//     idx0 + c, with no 64-bit division or modulo anywhere;
//   * where Nk % 16 == 0 every row starts 16-byte aligned and each item is
//     one 128-bit store (uint4); elsewhere the item's valid columns go out
//     as bytes, which covers a row's ragged tail;
//   * the grid is sized from the shape (ITEMS items a thread), not capped,
//     so a large mask keeps every SM full of warps to hide the stores'
//     latency.
// It is a probe, not on the train path.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <cuda_runtime.h>

#include <climits>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;
// items a thread takes per bh, THREADS items apart
constexpr int ITEMS = 4;

// chunks = ceil(Nk / 16), items of one bh = Nq * chunks (< 2**31, checked by
// the entry); step_rows / step_chunks = THREADS / chunks and THREADS % chunks.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    keep_mask_kernel(unsigned char* __restrict__ out, int BH, int Nq, int Nk, uint32_t chunks,
                     uint32_t step_rows, uint32_t step_chunks, uint32_t seed, uint32_t thr,
                     uint32_t nk_p, uint32_t q_off) {
  const uint32_t first = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
  uint32_t row = first / chunks;
  uint32_t chunk = first - row * chunks;
  uint32_t rows[ITEMS], chunk_of[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    rows[k] = row;
    chunk_of[k] = chunk;
    row += step_rows;
    chunk += step_chunks;
    if (chunk >= chunks) {
      chunk -= chunks;
      ++row;
    }
  }
  const long long per_bh = static_cast<long long>(Nq) * Nk;
#pragma unroll 1
  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const uint32_t folded = dropout_fold(dropout_base(seed, static_cast<uint32_t>(bh)));
    unsigned char* out_bh = out + bh * per_bh;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (rows[k] >= static_cast<uint32_t>(Nq)) break;
      const uint32_t col0 = chunk_of[k] * 16;
      // modulo 2**32, as JAX's uint32; the hash's row is the sequence's
      const uint32_t idx0 = (rows[k] + q_off) * nk_p + col0;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < 16; ++c)
        w[c >> 2] |= static_cast<uint32_t>(dropout_keep_idx(folded, idx0 + c, thr)) << (8 * (c & 3));
      unsigned char* dst = out_bh + static_cast<long long>(rows[k]) * Nk + col0;
      if (VEC) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        const int n = min(16, Nk - static_cast<int>(col0));
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (c < n) dst[c] = static_cast<unsigned char>(w[c >> 2] >> (8 * (c & 3)));
      }
    }
  }
}

}  // namespace

// out: a contiguous (BH, Nq, Nk) uint8 array, 16-byte aligned; BH, Nq,
// Nk >= 1 and Nq * ceil(Nk / 16) < 2**31; row r of out is the mask's row
// q_off + r (a strip's rows, as the attention kernels hash them). Returns
// the launch's cudaError_t.
extern "C" int dropout_keep_mask(void* out, int BH, int Nq, int Nk, unsigned seed, unsigned thr,
                                 unsigned nk_p, unsigned q_off, void* stream) {
  if (BH < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (Nk + 15LL) / 16;
  const long long items = static_cast<long long>(Nq) * chunks;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(THREADS) * ITEMS;
  const dim3 grid(static_cast<unsigned>((items + per_block - 1) / per_block),
                  static_cast<unsigned>(BH < 65535 ? BH : 65535));
  const uint32_t c = static_cast<uint32_t>(chunks);
  const uint32_t step_rows = THREADS / c, step_chunks = THREADS % c;
  auto* dst = static_cast<unsigned char*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (Nk % 16 == 0)
    keep_mask_kernel<true><<<grid, THREADS, 0, s>>>(dst, BH, Nq, Nk, c, step_rows, step_chunks,
                                                    seed, thr, nk_p, q_off);
  else
    keep_mask_kernel<false><<<grid, THREADS, 0, s>>>(dst, BH, Nq, Nk, c, step_rows, step_chunks,
                                                     seed, thr, nk_p, q_off);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dropout_keep_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
