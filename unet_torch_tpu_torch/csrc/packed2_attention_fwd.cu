// Two-head packed attention forward for NVIDIA Hopper (sm_90a), a probe:
//
//   o[b,h,i,:] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h,j,:]) v[b,h,j,:]
//
// bf16, head width 64, an even number of heads, no bias, no dropout. q and o
// are (B*H, Nq, 64), k and v (B*H, Nk, 64), contiguous.
//
// Replaces benchmarks/r8_attn_ab.py::packed2_fwd. That TPU probe asks whether
// two 64-wide heads fill a 128-lane matrix unit better together: it lays the
// two heads' q side by side, their k and v block-diagonally with zeros, and
// takes both heads' scores and outputs in one 128-deep product each. On
// Hopper a wgmma m64n64k16 is filled by one 64-wide head, so the zero blocks
// would only double the work, and the port does not copy them. What remains
// of the probe's question is "does a block that owns both heads of a pair
// hide more latency?", asked of the flash forward's wgmma design: this is
// the HEADS = 2 instance of csrc/flash_fwd_wgmma.cuh. One block of a producer
// warp and two consumer warpgroups owns 64 query rows of both heads of a
// pair, the even head on warpgroup 0 and the odd one on warpgroup 1; each
// TMA box of the ring is (64, 64, 2), both heads' K tiles (or V tiles) in
// one request, so a stage is 32 KB and the block holds 16 KB of Q. Two
// stages (81 KB) let two blocks share an SM; three (113 KB, one block an SM)
// measured 25-30% slower (PERF.md).
//
// What bounds it on an H100: as the flash forward, operations on paper (25.8
// GFLOP at the ViT's shape, 0.026 ms at the bf16 peak) and the schedulers'
// instruction rate and latency in fact. Against the flash forward's HEADS = 1 instance, each K
// and V tile that lands in shared memory feeds one warpgroup instead of two.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include "flash_fwd_wgmma.cuh"

// q, o (BH, Nq, 64) and k, v (BH, Nk, 64) bf16, contiguous and 16-byte
// aligned; BH even. The caller checks all of this. Returns the launch's
// cudaError_t.
extern "C" int packed2_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                                     int Nq, int Nk, float scale, void* stream) {
  if (BH < 2 || BH % 2 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.H = 2;
  p.Nq = Nq;
  p.Nk = Nk;
  p.dqk = 64;
  p.dv = 64;
  p.scale = scale;
  p.inv_keep = 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the scale is folded into the exponent only when it keeps the order of
  // the scores
  const cudaError_t err = scale > 0.f ? launch_wgmma<64, 64, false, false, 2, 2, 2>(p, BH, st)
                                      : launch_wgmma<64, 64, true, false, 2, 2, 2>(p, BH, st);
  return static_cast<int>(err);
}

extern "C" const char* packed2_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
