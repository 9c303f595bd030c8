// The attention-dropout keep mask as a (B*H, Nq, Nk) uint8 array of 0/1,
// written from the same device function (dropout_hash.cuh) that the flash
// attention forward and backward apply in registers.
//
// Replaces the mask-dump kernel of unet_torch_tpu/benchmarks/tpu_dfa_check.py
// (dump_hw_mask), which wrote the TPU kernel's keep bits so that they could be
// held against a plain oracle on silicon. Here the probe's bits are held,
// bit for bit, against the plain PyTorch hash (kernels/attention.py
// dropout_keep), which checks the device arithmetic that the attention
// kernels share.
//
// What bounds it on an H100: one byte written per element (about 100 MB at
// the ViT's (96, 1024, 1024), 0.03 ms at the card's bandwidth) against two
// 32-bit multiplies and six shift-xors each; a grid-stride loop with one
// element per thread per step, consecutive threads on consecutive bytes, is
// enough to keep the writes coalesced. It is a probe, not on the train path.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <cuda_runtime.h>

#include "dropout_hash.cuh"

namespace {

__global__ void keep_mask_kernel(unsigned char* __restrict__ out, int Nq, int Nk, long long total,
                                 uint32_t seed, uint32_t thr, uint32_t nk_p) {
  const long long per_bh = static_cast<long long>(Nq) * Nk;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint32_t bh = static_cast<uint32_t>(i / per_bh);
    const long long rem = i % per_bh;
    const uint32_t row = static_cast<uint32_t>(rem / Nk);
    const uint32_t col = static_cast<uint32_t>(rem % Nk);
    out[i] = dropout_keep(dropout_base(seed, bh), row, col, nk_p, thr) ? 1 : 0;
  }
}

}  // namespace

// out: a contiguous (BH, Nq, Nk) uint8 array; BH, Nq, Nk >= 1. Returns the
// launch's cudaError_t.
extern "C" int dropout_keep_mask(void* out, int BH, int Nq, int Nk, unsigned seed, unsigned thr,
                                 unsigned nk_p, void* stream) {
  if (BH < 1 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(BH) * Nq * Nk;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  keep_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out), Nq, Nk, total, seed, thr, nk_p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dropout_keep_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
