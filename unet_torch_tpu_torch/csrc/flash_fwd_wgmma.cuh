// The bf16 attention forward on wgmma + TMA for Hopper (sm_90a), shared by
// csrc/flash_attention_fwd.cu (the flash forward's eval and train calls at
// the width pairs (64, 64), (32, 32), (64, 32)) and
// csrc/packed2_attention_fwd.cu (the packed two-head probe at (64, 64)):
//
//   o[b,h,i,:] = sum_j keep_ij / (1 - rate) * p_ij v[b,h,j,:],
//   p_ij = softmax_j(scale * q[b,h,i,:] . k[b,h,j,:] + bias[b,j] - bmax[b])
//
// (see flash_attention_fwd.cu for the contract). A block of 288 threads is a
// producer warp and two consumer warpgroups of 64 query rows each. HEADS
// says what the two warpgroups share:
//
//   HEADS = 1: 128 query rows of one batch*head, rows 0-63 to warpgroup 0 and
//              64-127 to warpgroup 1; a stage of the ring is one K and one V
//              tile of 64 keys, read by both warpgroups.
//   HEADS = 2: 64 query rows of both heads of a pair (2 p, 2 p + 1), the even
//              head to warpgroup 0 and the odd one to warpgroup 1; a stage is
//              both heads' K tiles and both heads' V tiles, each landed by one
//              TMA box of (D, 64, 2) (the maps' box depth), and each
//              warpgroup reads its own head's half.
//
// The producer warp's first lane keeps a ring of STAGES stages in flight
// with TMA loads (3-D tensor maps (D, N, B*H), 128-byte swizzle at D = 64,
// 64-byte at D = 32, rows past N arriving as zeros) that complete on
// mbarriers; each consumer warp hands a stage back when its products have
// read it. S = Q K^T is one wgmma m64n64k16 chain with both operands in
// shared memory; P stays in the accumulator registers, is rounded to bf16
// there and is the register A operand of O += P V, with V read as an
// MN-major B operand. The softmax runs in the base-2 domain with the scale
// folded into the exponent's FMA unless GENERAL (a bias, or a scale <= 0).
// MIN_BLOCKS blocks an SM set the register cap through the launch bound:
// two blocks of nine warps give 96 registers a thread, one lifts the cap
// (the build's log says what ptxas used).
//
// kernels/build.py hashes this header with each source.

#pragma once

#include <math_constants.h>

#include "dropout_hash.cuh"
#include "hopper_mma.cuh"

namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;      // (B, Nk) or null
  const float* bias_max;  // (B,), given with bias
  void* o;
  float* lse;  // (B*H, Nq) natural log, or null (eval)
  int H, Nq, Nk, dqk, dv, q_tiles;
  float scale;
  uint32_t seed, thr, nk_p;  // dropout: keep = hash >= thr
  float inv_keep;            // 1 / (1 - rate)
  int b_off, h_off, h_total;  // the mask's global batch*head (dropout_bh)
  int q_off;                  // the mask's global row of query row 0
};

constexpr int BKV = 64;            // key rows per tile
constexpr int WG_ROWS = 64;        // query rows per consumer warpgroup
constexpr int WG_CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and one producer warp

// query rows of one head a block owns
template <int HEADS>
__host__ __device__ constexpr int wg_block_rows() {
  return 2 * WG_ROWS / HEADS;
}

template <int DQK, int DV, int HEADS, int STAGES>
constexpr int smem_bytes_wgmma() {
  return 2 * tile_bytes<64, DQK>() +
         STAGES * HEADS * (tile_bytes<BKV, DQK>() + tile_bytes<BKV, DV>()) +
         1024 /* alignment */ + 64 /* barriers */;
}

// One 64 x 64 tile of the online softmax on the raw S accumulators: on
// return s holds the unnormalised probabilities (dropped ones zero, the
// survivors not yet scaled by 1 / (1 - rate)), m_run and l_run are updated
// and corr holds the factors by which the earlier sums shrink. GENERAL: a
// bias or a scale <= 0 (x = s * scale2 is formed before the maximum);
// otherwise the scale is folded into the exponent's FMA. MASKED: the tile
// holds columns >= Nk.
template <bool GENERAL, bool MASKED, bool DROPOUT>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], const FwdParams& p,
                                             const float* bg, float bmax2, float scale2, int k0,
                                             int t4, const uint32_t (&row)[2], uint32_t folded) {
  float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + 2 * t4 + (e & 1);
      float x = s[4 * j + e];
      if constexpr (GENERAL) {
        x *= scale2;
        // the bias first (a -1e30 swallows the score), then the row shift
        if (bg != nullptr && (!MASKED || col < p.Nk)) x = (x + bg[col] * LOG2E) - bmax2;
      }
      if constexpr (MASKED) x = col < p.Nk ? x : -CUDART_INF_F;
      s[4 * j + e] = x;
      m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
    }
  float shift[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    // every tile holds a real key, so m_new is finite; exp2(-inf) = 0
    const float f = GENERAL ? 1.f : scale2;
    corr[i] = fast_exp2((m_run[i] - m_new[i]) * f);
    shift[i] = m_new[i] * f;
    m_run[i] = m_new[i];
    l_run[i] *= corr[i];
  }
  uint32_t idx0[2] = {0u, 0u};
  if constexpr (DROPOUT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) idx0[i] = row[i] * p.nk_p + static_cast<uint32_t>(k0 + 2 * t4);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = GENERAL ? fast_exp2(s[4 * j + e] - shift[e >> 1])
                         : fast_exp2(fmaf(s[4 * j + e], scale2, -shift[e >> 1]));
      l_run[e >> 1] += pr;  // the row sum is taken before dropout
      if constexpr (DROPOUT)
        pr = dropout_keep_idx(folded, idx0[e >> 1] + static_cast<uint32_t>(j * 8 + (e & 1)), p.thr)
                 ? pr
                 : 0.f;
      s[4 * j + e] = pr;
    }
}

template <int DQK, int DV, bool GENERAL, bool DROPOUT, int HEADS, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(WG_THREADS, MIN_BLOCKS)
    flash_fwd_wgmma(const FwdParams p, const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v) {
  static_assert(HEADS == 1 || HEADS == 2, "one head a block, or a pair");
  constexpr int QB = tile_bytes<64, DQK>();
  constexpr int KB = tile_bytes<BKV, DQK>();
  constexpr int VB = tile_bytes<BKV, DV>();
  constexpr int ROWS = wg_block_rows<HEADS>();
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* Qs = align_1024(wsmem);       // two tiles, one a consumer warpgroup
  unsigned char* Ks = Qs + 2 * QB;             // STAGES x HEADS tiles
  unsigned char* Vs = Ks + STAGES * HEADS * KB;  // STAGES x HEADS tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * HEADS * VB);
  uint64_t* full = q_full + 1;                 // STAGES: the stage has landed
  uint64_t* empty = full + STAGES;             // STAGES: both warpgroups are done with it

  const int Nq = p.Nq, Nk = p.Nk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh0 = (blockIdx.x / p.q_tiles) * HEADS;  // the block's first batch*head
  const int q0 = (blockIdx.x % p.q_tiles) * ROWS;
  const int kv_tiles = (Nk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WG_CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * QB);
      if constexpr (HEADS == 1) {
        tma_load_3d(Qs, &map_q, q_full, 0, q0, bh0);
        tma_load_3d(Qs + QB, &map_q, q_full, 0, q0 + WG_ROWS, bh0);
      } else {
        tma_load_3d(Qs, &map_q, q_full, 0, q0, bh0);  // both heads' tiles in one box
      }
      for (int t = 0; t < kv_tiles; ++t) {
        const int stage = t % STAGES;
        mbar_wait(empty + stage, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + stage, HEADS * (KB + VB));
        tma_load_3d(Ks + stage * HEADS * KB, &map_k, full + stage, 0, t * BKV, bh0);
        tma_load_3d(Vs + stage * HEADS * VB, &map_v, full + stage, 0, t * BKV, bh0);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const int w = warp % 4;   // warp within the warpgroup: rows 16 w .. 16 w + 15
  const int g = lane / 4;   // accumulator row (and row + 8)
  const int t4 = lane % 4;  // accumulator column pair
  const int head = HEADS == 2 ? wg : 0;  // this warpgroup's head within the block
  const int bh = bh0 + head;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax2 = p.bias ? p.bias_max[bh / p.H] * LOG2E : 0.f;
  const float scale2 = p.scale * LOG2E;  // scores in the base-2 domain
  const int row0 = q0 + (HEADS == 1 ? wg * WG_ROWS : 0) + w * 16 + g;
  // the mask's rows: this thread's query rows in the whole sequence
  const uint32_t row[2] = {static_cast<uint32_t>(row0 + p.q_off),
                           static_cast<uint32_t>(row0 + 8 + p.q_off)};
  uint32_t folded = 0;
  if constexpr (DROPOUT)
    folded = dropout_fold(dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total)));

  mbar_wait(q_full, 0);
  const unsigned char* Qt = Qs + wg * QB;

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g, g + 8
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = 0; t < kv_tiles; ++t) {
    const int stage = t % STAGES;
    mbar_wait(full + stage, (t / STAGES) & 1);
    const unsigned char* Kt = Ks + (stage * HEADS + head) * KB;
    const unsigned char* Vt = Vs + (stage * HEADS + head) * VB;

    // S = Q K^T: both operands read from shared memory by the tensor cores
    float s[BKV / 2];
    wgmma_fence();
    wgmma_ss_tile<DQK>(s, Qt, Kt);
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(s);

    float corr[2];
    if (t == kv_tiles - 1 && (Nk % BKV) != 0)
      softmax_tile<GENERAL, true, DROPOUT>(s, m_run, l_run, corr, p, bg, bmax2, scale2, t * BKV, t4,
                                           row, folded);
    else
      softmax_tile<GENERAL, false, DROPOUT>(s, m_run, l_run, corr, p, bg, bmax2, scale2, t * BKV,
                                            t4, row, folded);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // O += P V: P goes from the S accumulators to the register A operand as
    // bf16; V lies [key][d] and is read as the MN-major B operand
    uint32_t pa[4][4];
    pack_a(pa, s);
    wgmma_fence();
    wgmma_rs_tile<DV>(acc, pa, Vt);
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(acc);
    keep_regs(pa);
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
  }

  float l_row[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv[i] = (DROPOUT ? p.inv_keep : 1.f) / l;
  }
  bf16* og = static_cast<bf16*>(p.o) + static_cast<long long>(bh) * Nq * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < Nq)
        *reinterpret_cast<uint32_t*>(og + static_cast<long long>(r) * DV + col) =
            pack_bf16x2(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  if (p.lse != nullptr && t4 == 0) {
    const float f = GENERAL ? 1.f : scale2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < Nq)
        p.lse[static_cast<long long>(bh) * Nq + r] = (m_run[i] * f + log2f(l_row[i])) * LN2;
    }
  }
}

// One launch over BH batch*heads (BH a multiple of HEADS); sets p.q_tiles.
template <int DQK, int DV, bool GENERAL, bool DROPOUT, int HEADS, int STAGES, int MIN_BLOCKS>
cudaError_t launch_wgmma(FwdParams p, int BH, cudaStream_t stream) {
  constexpr int smem = smem_bytes_wgmma<DQK, DV, HEADS, STAGES>();
  auto kernel = flash_fwd_wgmma<DQK, DV, GENERAL, DROPOUT, HEADS, STAGES, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v;
  if ((err = make_tile_map<DQK>(&map_q, p.q, p.Nq, BH, HEADS)) != cudaSuccess) return err;
  if ((err = make_tile_map<DQK>(&map_k, p.k, p.Nk, BH, HEADS)) != cudaSuccess) return err;
  if ((err = make_tile_map<DV>(&map_v, p.v, p.Nk, BH, HEADS)) != cudaSuccess) return err;
  constexpr int rows = wg_block_rows<HEADS>();
  p.q_tiles = (p.Nq + rows - 1) / rows;
  kernel<<<p.q_tiles * (BH / HEADS), WG_THREADS, smem, stream>>>(p, map_q, map_k, map_v);
  return cudaGetLastError();
}

}  // namespace
