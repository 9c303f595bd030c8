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
// takes both heads' scores and outputs in one 128-deep product each, over
// the whole K held in VMEM. On Hopper the tensor-core instruction is
// m16n8k16, which a 64-wide head fills without padding, so the zero blocks
// would only double the work; and the whole K of two heads does not fit a
// block's shared memory. What remains of "two heads per program" is one
// block that owns one 64-row query tile of both heads of a pair: 8 warps,
// warps 0-3 on the even head and 4-7 on the odd one, 16 query rows a warp,
// both heads' K and V tiles of 64 rows double-buffered in shared memory by
// cp.async (92 KB, two blocks an SM), each warp running the flash forward's
// loop (S = Q K^T and O += P V on mma.sync m16n8k16, the online softmax in
// f32 registers in the base-2 domain, P kept in registers as bf16 A
// fragments). It shares flash_tiles.cuh and warp_mma.cuh with
// csrc/flash_attention_fwd.cu and differs from it in the block's shape only:
// half as many blocks, twice the warps, and both heads' barriers in step.
//
// What bounds it on an H100: as the flash forward, operations on paper (25.8
// GFLOP at the ViT's shape, 0.026 ms at the bf16 peak) and latency in fact.
// The probe answers whether pairing heads in a block hides more of it.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <math_constants.h>

#include "flash_tiles.cuh"

namespace {

constexpr int D = 64;
constexpr int HEAD_THREADS = 128;  // 4 warps a head
constexpr int THREADS = 2 * HEAD_THREADS;
constexpr int BQ = 64;   // query rows per head and block, 16 per warp
constexpr int BKV = 64;  // key rows per tile
constexpr int LD = Pitch<D>::LD;
constexpr int TILE = BKV * LD;  // elements of one staged tile
// per head: Q, two K tiles, two V tiles
constexpr int SMEM_BYTES = 2 * 5 * TILE * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(THREADS)
packed2_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Nq, int Nk, int q_tiles,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int head = tid / HEAD_THREADS;  // 0: the pair's even head, 1: the odd one
  const int htid = tid % HEAD_THREADS;
  const int warp = htid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem) + head * 5 * TILE;
  bf16* Ks = Qs + TILE;       // two tiles
  bf16* Vs = Ks + 2 * TILE;   // two tiles

  const int bh = 2 * (blockIdx.x / q_tiles) + head;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const bf16* qg = q + static_cast<long long>(bh) * Nq * D;
  const bf16* kg = k + static_cast<long long>(bh) * Nk * D;
  const bf16* vg = v + static_cast<long long>(bh) * Nk * D;
  const float scale2 = scale * LOG2E;

  load_tile<BQ, D, HEAD_THREADS>(Qs, qg, q0, Nq, D, htid);
  load_tile<BKV, D, HEAD_THREADS>(Ks, kg, 0, Nk, D, htid);
  load_tile<BKV, D, HEAD_THREADS>(Vs, vg, 0, Nk, D, htid);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  const int kv_tiles = (Nk + BKV - 1) / BKV;
  for (int t = 0; t < kv_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < kv_tiles) {
      load_tile<BKV, D, HEAD_THREADS>(Ks + (buf ^ 1) * TILE, kg, (t + 1) * BKV, Nk, D, htid);
      load_tile<BKV, D, HEAD_THREADS>(Vs + (buf ^ 1) * TILE, vg, (t + 1) * BKV, Nk, D, htid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BKV / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Kt + (j * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[j], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[j + 1], qf[kk], r[2], r[3]);
      }

    const int k0 = t * BKV;
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const float x = col < Nk ? s[j][e] * scale2 : -CUDART_INF_F;
        s[j][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      corr[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[j][e] - m_new[e >> 1]);
        l_run[e >> 1] += pr;
        s[j][e] = pr;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16_16816(acc[j], a, r[0], r[1]);
        mma_bf16_16816(acc[j + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / l;
  }
  const int row0 = q0 + warp * 16 + g;
  bf16* og = o + static_cast<long long>(bh) * Nq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Nq)
        *reinterpret_cast<uint32_t*>(og + static_cast<long long>(row) * D + col) =
            pack_bf16x2(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace

// q, o (BH, Nq, 64) and k, v (BH, Nk, 64) bf16, contiguous and 16-byte
// aligned; BH even. The caller checks all of this. Returns the launch's
// cudaError_t.
extern "C" int packed2_attention_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                                     int Nq, int Nk, float scale, void* stream) {
  if (BH < 2 || BH % 2 || Nq < 1 || Nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      packed2_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (Nq + BQ - 1) / BQ;
  packed2_fwd_bf16<<<q_tiles * (BH / 2), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Nq, Nk, q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packed2_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
