// Attention backward for NVIDIA Hopper (sm_90a): FlashAttention-2 form, bf16
// on the tensor cores and a plain f32 form on the CUDA cores.
//
// Replaces the TPU kernels _dropout_flash_bwd (two passes: dk/dv, then dq)
// and _dropout_flash_bwd1 (one merged pass) of
// unet_torch_tpu/kernels/attention.py, and serves as the backward of
// _attention_pallas / _attention_flash as well (their VJPs recompute the
// probabilities with einsums, _einsum_bwd; here the same kernel takes their
// optional (B, Nk) bias). With the forward's row log-sum-exp lse and
// D = rowsum(g * o), for each batch*head:
//
//   p_ij  = exp(scale * q_i . k_j + bias_j - bmax - lse_i)   (recomputed)
//   dv_j  = sum_i keep_ij / (1 - rate) * p_ij g_i
//   dp_ij = keep_ij / (1 - rate) * g_i . v_j
//   ds_ij = p_ij (dp_ij - D_i)
//   dk_j  = scale * sum_i ds_ij q_i,    dq_i = scale * sum_j ds_ij k_j
//
// keep is the counter hash of dropout_hash.cuh, regenerated from the global
// (row, col) exactly as the forward drew it. The bias gets no gradient (zero,
// as _masked_bwd gives it).
//
// bf16 design, two kernels. dK/dV: a block of 4 warps owns 64 keys of one
// batch*head, 16 per warp, and walks the queries in tiles of 64. Its K and V
// rows stay in shared memory, its dK and dV sums in f32 registers for the
// whole walk; Q, dO, lse and D tiles are double-buffered with cp.async. Each
// warp computes its 16 x 64 slice of S^T = K Q^T and dP^T = V dO^T with
// mma.sync m16n8k16, so that P^T and dS^T sit in registers with the keys as
// rows: the accumulators of two adjacent n8 tiles are the A fragment of one
// k16 step of dV += P^T dO and dK += dS^T Q, which never leave registers.
// dQ needs a sum over the keys, across the dK/dV blocks, so a second kernel
// takes it: a block owns 64 queries and walks the keys, recomputing S and
// dP; dS stays in registers as the A operand of dQ += dS K, and dQ is written
// once. The other way, f32 atomics of each dK/dV block's dS K into a dQ
// buffer (FlashAttention-2's), was measured on the card against this one:
// 0.754-0.835 ms against 0.674-0.685 ms at the ViT's shape at rate 0, the
// train path's rate (0.841-0.870 against 0.881-0.918 ms at rate 0.1), so the
// second kernel stays (PERF.md).
//
// What bounds it on an H100: at the ViT's shape (B*H = 96, N = 1024, D = 64)
// the seven products of the two kernels are 90 GFLOP, 0.09 ms at the bf16
// peak; the exp unit computes 200 M exponentials (0.05 ms); device memory
// moves q, k, v, o, g, dq, dk, dv (about 100 MB, 0.03 ms). It takes
// 0.67-0.76 ms: like the forward it is latency bound. Each warp runs its
// products and the softmax backward one after the other, and 232-252
// registers a thread leave one or two 4-warp blocks on an SM.
//
// f32 design: two CUDA-core kernels (dK/dV over key tiles of 32 rows, then dQ
// over query tiles of 32 rows, each recomputing the scores), summed in full
// f32 so that the kernel can be held against a reference with TF32 off.
// Speed is not its purpose.
//
// The C entry point returns the first failing launch's cudaError_t; the
// Python wrapper raises on nonzero.

#include <math_constants.h>

#include "dropout_hash.cuh"
#include "flash_tiles.cuh"

namespace {

constexpr int THREADS = 128;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;          // dO, (B*H, Nq, dv)
  const float* lse;       // (B*H, Nq), natural log
  const float* dsum;      // D = rowsum(g * o), (B*H, Nq)
  const float* bias;      // (B, Nk) or null
  const float* bias_max;  // (B,), given with bias
  void* dq;               // (B*H, Nq, dqk)
  void* dk;
  void* dv;
  int H, Nq, Nk, dqk, dv_, tiles;
  float scale;
  uint32_t seed, thr, nk_p;
  float inv_keep;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK2 = 64;  // keys per dK/dV block, 16 per warp
constexpr int BQ2 = 64;  // query rows per tile

template <int DQK, int DV>
constexpr int smem_bytes_dkdv() {
  return (BK2 * Pitch<DQK>::LD + BK2 * Pitch<DV>::LD + 2 * BQ2 * Pitch<DQK>::LD +
          2 * BQ2 * Pitch<DV>::LD) *
             static_cast<int>(sizeof(bf16)) +
         4 * BQ2 * static_cast<int>(sizeof(float));
}

template <int DQK, int DV, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_bf16(const BwdParams p) {
  constexpr int LDQ = Pitch<DQK>::LD;
  constexpr int LDV = Pitch<DV>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK2 * LDQ;
  bf16* Qs = Vs + BK2 * LDV;                                 // two tiles
  bf16* Gs = Qs + 2 * BQ2 * LDQ;                             // two tiles
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ2 * LDV);  // two tiles
  float* Ds = Ls + 2 * BQ2;                                  // two tiles

  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv_;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x % p.tiles) * BK2;
  const long long bhq = static_cast<long long>(bh) * Nq;
  const bf16* qg = static_cast<const bf16*>(p.q) + bhq * dqk;
  const bf16* gg = static_cast<const bf16*>(p.g) + bhq * dv;
  const bf16* kg = static_cast<const bf16*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const bf16* vg = static_cast<const bf16*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* lg = p.lse + bhq;
  const float* dg = p.dsum + bhq;
  const float scale2 = p.scale * LOG2E;
  uint32_t base = 0;
  if constexpr (DROPOUT) base = dropout_base(p.seed, static_cast<uint32_t>(bh));

  // this thread's two key rows (accumulator rows g and g + 8 of its warp)
  int key[2];
  float bx[2] = {0.f, 0.f};
  const float bmax2 = p.bias ? p.bias_max[bh / p.H] * LOG2E : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + 8 * i;
    if (p.bias != nullptr && key[i] < Nk)
      bx[i] = p.bias[static_cast<long long>(bh / p.H) * Nk + key[i]] * LOG2E;
  }

  load_tile<BK2, DQK, THREADS>(Ks, kg, k0, Nk, dqk, tid);
  load_tile<BK2, DV, THREADS>(Vs, vg, k0, Nk, dv, tid);
  load_tile<BQ2, DQK, THREADS>(Qs, qg, 0, Nq, dqk, tid);
  load_tile<BQ2, DV, THREADS>(Gs, gg, 0, Nq, dv, tid);
  cp_async_commit();
  if (tid < BQ2) {
    Ls[tid] = tid < Nq ? lg[tid] * LOG2E : 0.f;
    Ds[tid] = tid < Nq ? dg[tid] : 0.f;
  }

  float dk[DQK / 8][4], dvacc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dvacc[j][e] = 0.f;

  const int q_tiles = (Nq + BQ2 - 1) / BQ2;
  for (int t = 0; t < q_tiles; ++t) {
    const int buf = t & 1;
    const int q0 = t * BQ2;
    if (t + 1 < q_tiles) {
      const int q1 = q0 + BQ2;
      load_tile<BQ2, DQK, THREADS>(Qs + (buf ^ 1) * BQ2 * LDQ, qg, q1, Nq, dqk, tid);
      load_tile<BQ2, DV, THREADS>(Gs + (buf ^ 1) * BQ2 * LDV, gg, q1, Nq, dv, tid);
      if (tid < BQ2) {
        Ls[(buf ^ 1) * BQ2 + tid] = q1 + tid < Nq ? lg[q1 + tid] * LOG2E : 0.f;
        Ds[(buf ^ 1) * BQ2 + tid] = q1 + tid < Nq ? dg[q1 + tid] : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and, at t = 0, K and V) has landed
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ2 * LDQ;
    const bf16* Gt = Gs + buf * BQ2 * LDV;
    const float* Lt = Ls + buf * BQ2;
    const float* Dt = Ds + buf * BQ2;

    // S^T = K Q^T: this warp's 16 keys (A, from K rows) against 64 queries
    // (B: Q lies [query][d], the column-major B operand as it is)
    float st[BQ2 / 8][4];
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Ks + (warp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < BQ2 / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Qt + (j * 8 + (lane / 16) * 8 + lane % 8) * LDQ + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(st[j], a, r[0], r[1]);
        mma_bf16_16816(st[j + 1], a, r[2], r[3]);
      }
    }

    // P^T, and the keep bits of its 32 entries
    uint32_t keep_bits = 0;
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qc = j * 8 + 2 * t4 + (e & 1);  // query within the tile
        float x = st[j][e] * scale2;
        if (p.bias != nullptr) x = (x + bx[i]) - bmax2;
        const bool valid = key[i] < Nk && q0 + qc < Nq;
        st[j][e] = valid ? exp2f(x - Lt[qc]) : 0.f;
        if constexpr (DROPOUT) {
          if (dropout_keep(base, static_cast<uint32_t>(q0 + qc), static_cast<uint32_t>(key[i]),
                           p.nk_p, p.thr))
            keep_bits |= 1u << (j * 4 + e);
        }
      }

    // dV += P_drop^T dO: dO lies [query][d], loaded transposed
#pragma unroll
    for (int kc = 0; kc < BQ2 / 16; ++kc) {
      float pd[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kc + h;
          float x = st[j][e];
          if constexpr (DROPOUT) x = (keep_bits >> (j * 4 + e)) & 1u ? x * p.inv_keep : 0.f;
          pd[h][e] = x;
        }
      uint32_t a[4];
      a[0] = pack_bf16x2(pd[0][0], pd[0][1]);
      a[1] = pack_bf16x2(pd[0][2], pd[0][3]);
      a[2] = pack_bf16x2(pd[1][0], pd[1][1]);
      a[3] = pack_bf16x2(pd[1][2], pd[1][3]);
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Gt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16_16816(dvacc[j], a, r[0], r[1]);
        mma_bf16_16816(dvacc[j + 1], a, r[2], r[3]);
      }
    }

    // dP^T = V dO^T: this warp's 16 keys (A, from V rows) against 64 queries
    float ds[BQ2 / 8][4];
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Vs + (warp * 16 + lane % 16) * LDV + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < BQ2 / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Gt + (j * 8 + (lane / 16) * 8 + lane % 8) * LDV + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(ds[j], a, r[0], r[1]);
        mma_bf16_16816(ds[j + 1], a, r[2], r[3]);
      }
    }

    // dS^T = P^T (dP_drop^T - D)
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dp = ds[j][e];
        if constexpr (DROPOUT) dp = (keep_bits >> (j * 4 + e)) & 1u ? dp * p.inv_keep : 0.f;
        ds[j][e] = st[j][e] * (dp - Dt[j * 8 + 2 * t4 + (e & 1)]);
      }

    // dK += dS^T Q: Q lies [query][d], loaded transposed
#pragma unroll
    for (int kc = 0; kc < BQ2 / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(ds[2 * kc][0], ds[2 * kc][1]);
      a[1] = pack_bf16x2(ds[2 * kc][2], ds[2 * kc][3]);
      a[2] = pack_bf16x2(ds[2 * kc + 1][0], ds[2 * kc + 1][1]);
      a[3] = pack_bf16x2(ds[2 * kc + 1][2], ds[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < DQK / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Qt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDQ + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16_16816(dk[j], a, r[0], r[1]);
        mma_bf16_16816(dk[j + 1], a, r[2], r[3]);
      }
    }

    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  bf16* dkg = static_cast<bf16*>(p.dk) + static_cast<long long>(bh) * Nk * dqk;
  bf16* dvg = static_cast<bf16*>(p.dv) + static_cast<long long>(bh) * Nk * dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Nk) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col < dqk)
        *reinterpret_cast<uint32_t*>(dkg + static_cast<long long>(key[i]) * dqk + col) =
            pack_bf16x2(dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col < dv)
        *reinterpret_cast<uint32_t*>(dvg + static_cast<long long>(key[i]) * dv + col) =
            pack_bf16x2(dvacc[j][2 * i], dvacc[j][2 * i + 1]);
    }
  }
}

// The second-pass dQ kernel: a block of 4 warps owns 64 query rows, 16 per
// warp, and walks the keys in tiles of 64, recomputing S = Q K^T and
// dP = dO V^T; dS stays in registers as the A operand of dQ += dS K.
constexpr int BQ3 = 64;
constexpr int BK3 = 64;

template <int DQK, int DV>
constexpr int smem_bytes_dq() {
  return (BQ3 * Pitch<DQK>::LD + BQ3 * Pitch<DV>::LD + 2 * BK3 * Pitch<DQK>::LD +
          2 * BK3 * Pitch<DV>::LD) *
         static_cast<int>(sizeof(bf16));
}

template <int DQK, int DV, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_bf16(const BwdParams p) {
  constexpr int LDQ = Pitch<DQK>::LD;
  constexpr int LDV = Pitch<DV>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BQ3 * LDQ;
  bf16* Ks = Gs + BQ3 * LDV;       // two tiles
  bf16* Vs = Ks + 2 * BK3 * LDQ;   // two tiles

  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv_;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x % p.tiles) * BQ3;
  const long long bhq = static_cast<long long>(bh) * Nq;
  const bf16* qg = static_cast<const bf16*>(p.q) + bhq * dqk;
  const bf16* gg = static_cast<const bf16*>(p.g) + bhq * dv;
  const bf16* kg = static_cast<const bf16*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const bf16* vg = static_cast<const bf16*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax2 = p.bias ? p.bias_max[bh / p.H] * LOG2E : 0.f;
  const float scale2 = p.scale * LOG2E;
  uint32_t base = 0;
  if constexpr (DROPOUT) base = dropout_base(p.seed, static_cast<uint32_t>(bh));

  int row[2];
  float lse2[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    lse2[i] = row[i] < Nq ? p.lse[bhq + row[i]] * LOG2E : 0.f;
    drow[i] = row[i] < Nq ? p.dsum[bhq + row[i]] : 0.f;
  }

  load_tile<BQ3, DQK, THREADS>(Qs, qg, q0, Nq, dqk, tid);
  load_tile<BQ3, DV, THREADS>(Gs, gg, q0, Nq, dv, tid);
  load_tile<BK3, DQK, THREADS>(Ks, kg, 0, Nk, dqk, tid);
  load_tile<BK3, DV, THREADS>(Vs, vg, 0, Nk, dv, tid);
  cp_async_commit();

  uint32_t qf[DQK / 16][4], gf[DV / 16][4];
  float dq[DQK / 8][4];
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int kv_tiles = (Nk + BK3 - 1) / BK3;
  for (int t = 0; t < kv_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < kv_tiles) {
      load_tile<BK3, DQK, THREADS>(Ks + (buf ^ 1) * BK3 * LDQ, kg, (t + 1) * BK3, Nk, dqk, tid);
      load_tile<BK3, DV, THREADS>(Vs + (buf ^ 1) * BK3 * LDV, vg, (t + 1) * BK3, Nk, dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        ldmatrix_x4(gf[kk], Gs + (warp * 16 + lane % 16) * LDV + kk * 16 + (lane / 16) * 8);
    }
    const bf16* Kt = Ks + buf * BK3 * LDQ;
    const bf16* Vt = Vs + buf * BK3 * LDV;
    const int k0 = t * BK3;

    float s[BK3 / 8][4], dp[BK3 / 8][4];
#pragma unroll
    for (int j = 0; j < BK3 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // S = Q K^T and dP = dO V^T: K and V lie [key][d], the B operand as it is
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BK3 / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Kt + (j * 8 + (lane / 16) * 8 + lane % 8) * LDQ + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[j], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[j + 1], qf[kk], r[2], r[3]);
      }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BK3 / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Vt + (j * 8 + (lane / 16) * 8 + lane % 8) * LDV + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(dp[j], gf[kk], r[0], r[1]);
        mma_bf16_16816(dp[j + 1], gf[kk], r[2], r[3]);
      }

    // dS = P (dP_drop - D)
#pragma unroll
    for (int j = 0; j < BK3 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        float x = s[j][e] * scale2;
        if (bg != nullptr && col < Nk) x = (x + bg[col] * LOG2E) - bmax2;
        const float pr = col < Nk && row[i] < Nq ? exp2f(x - lse2[i]) : 0.f;
        float d = dp[j][e];
        if constexpr (DROPOUT)
          d = dropout_keep(base, static_cast<uint32_t>(row[i]), static_cast<uint32_t>(col),
                           p.nk_p, p.thr)
                  ? d * p.inv_keep
                  : 0.f;
        s[j][e] = pr * (d - drow[i]);
      }

    // dQ += dS K: K lies [key][d], loaded transposed
#pragma unroll
    for (int kc = 0; kc < BK3 / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < DQK / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Kt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDQ + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16_16816(dq[j], a, r[0], r[1]);
        mma_bf16_16816(dq[j + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(p.dq) + bhq * dqk;
#pragma unroll
  for (int j = 0; j < DQK / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    if (col >= dqk) break;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Nq)
        *reinterpret_cast<uint32_t*>(dqg + static_cast<long long>(row[i]) * dqk + col) =
            pack_bf16x2(dq[j][2 * i] * p.scale, dq[j][2 * i + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BT_F = 32;  // rows per tile, four threads a row
constexpr int DMAX = 128;
constexpr int LDP_F = BT_F + 1;

inline int smem_bytes_f32(int dqk, int dv) {
  return (2 * BT_F * (dqk + 1) + 2 * BT_F * (dv + 1) + 2 * BT_F * LDP_F + 2 * BT_F) *
         static_cast<int>(sizeof(float));
}

// The score of (query qi, key kj) in natural units, as the forward forms it.
__device__ __forceinline__ float score_f32(const float* qrow, const float* krow, int dqk,
                                           float scale, const float* bg, int key, float bmax) {
  float dot = 0.f;
  for (int d = 0; d < dqk; ++d) dot = fmaf(qrow[d], krow[d], dot);
  float x = dot * scale;
  if (bg != nullptr) x = (x + bg[key]) - bmax;
  return x;
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// dK, dV: a block of 128 threads owns 32 keys, four threads a key; query
// tiles of 32 rows go through shared memory.
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_f32(const BwdParams p) {
  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv_;
  const int ldk = dqk + 1, ldv = dv + 1;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;
  float* Qs = Ks + BT_F * ldk;
  float* Vs = Qs + BT_F * ldk;
  float* Gs = Vs + BT_F * ldv;
  float* Ps = Gs + BT_F * ldv;  // p_drop^T, [key][query]
  float* Ss = Ps + BT_F * LDP_F;  // ds^T
  float* Ls = Ss + BT_F * LDP_F;
  float* Dsh = Ls + BT_F;

  const int tid = threadIdx.x;
  const int r = tid / 4;  // this thread's key in the tile
  const int c = tid % 4;  // queries c, c+4, ...; output columns c, c+4, ...
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x % p.tiles) * BT_F;
  const long long bhq = static_cast<long long>(bh) * Nq;
  const float* qg = static_cast<const float*>(p.q) + bhq * dqk;
  const float* gg = static_cast<const float*>(p.g) + bhq * dv;
  const float* kg = static_cast<const float*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const float* vg = static_cast<const float*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax = p.bias ? p.bias_max[bh / p.H] : 0.f;
  const uint32_t base = dropout_base(p.seed, static_cast<uint32_t>(bh));
  const int key = k0 + r;

  load_tile_f32<BT_F, THREADS>(Ks, kg, k0, Nk, dqk, ldk, tid);
  load_tile_f32<BT_F, THREADS>(Vs, vg, k0, Nk, dv, ldv, tid);
  float acc_k[DMAX / 4], acc_v[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int q0 = 0; q0 < Nq; q0 += BT_F) {
    __syncthreads();  // the previous tile is consumed (and K, V are written)
    load_tile_f32<BT_F, THREADS>(Qs, qg, q0, Nq, dqk, ldk, tid);
    load_tile_f32<BT_F, THREADS>(Gs, gg, q0, Nq, dv, ldv, tid);
    if (tid < BT_F) {
      Ls[tid] = q0 + tid < Nq ? p.lse[bhq + q0 + tid] : 0.f;
      Dsh[tid] = q0 + tid < Nq ? p.dsum[bhq + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < BT_F / 4; ++jj) {
      const int qi = c + 4 * jj;
      float pr = 0.f, pd = 0.f, ds = 0.f;
      if (key < Nk && q0 + qi < Nq) {
        pr = expf(score_f32(Qs + qi * ldk, Ks + r * ldk, dqk, p.scale, bg, key, bmax) - Ls[qi]);
        float dp = dot_f32(Gs + qi * ldv, Vs + r * ldv, dv);
        pd = pr;
        if (p.thr != 0u) {
          const bool keep = dropout_keep(base, q0 + qi, key, p.nk_p, p.thr);
          pd = keep ? pr * p.inv_keep : 0.f;
          dp = keep ? dp * p.inv_keep : 0.f;
        }
        ds = pr * (dp - Dsh[qi]);
      }
      Ps[r * LDP_F + qi] = pd;
      Ss[r * LDP_F + qi] = ds;
    }
    __syncwarp();  // a key's four threads are in one warp
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c + 4 * j;
      if (col < dv) {
        float sum = 0.f;
        for (int qi = 0; qi < BT_F; ++qi) sum = fmaf(Ps[r * LDP_F + qi], Gs[qi * ldv + col], sum);
        acc_v[j] += sum;
      }
      if (col < dqk) {
        float sum = 0.f;
        for (int qi = 0; qi < BT_F; ++qi) sum = fmaf(Ss[r * LDP_F + qi], Qs[qi * ldk + col], sum);
        acc_k[j] += sum;
      }
    }
  }
  if (key >= Nk) return;
  float* dkg = static_cast<float*>(p.dk) + (static_cast<long long>(bh) * Nk + key) * dqk;
  float* dvg = static_cast<float*>(p.dv) + (static_cast<long long>(bh) * Nk + key) * dv;
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) {
    const int col = c + 4 * j;
    if (col < dqk) dkg[col] = acc_k[j] * p.scale;
    if (col < dv) dvg[col] = acc_v[j];
  }
}

// dQ: a block of 128 threads owns 32 queries, four threads a query; key
// tiles of 32 rows go through shared memory.
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32(const BwdParams p) {
  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv_;
  const int ldk = dqk + 1, ldv = dv + 1;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + BT_F * ldk;
  float* Gs = Ks + BT_F * ldk;
  float* Vs = Gs + BT_F * ldv;
  float* Ss = Vs + BT_F * ldv;  // ds, [query][key]

  const int tid = threadIdx.x;
  const int r = tid / 4;  // this thread's query in the tile
  const int c = tid % 4;  // keys c, c+4, ...; output columns c, c+4, ...
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x % p.tiles) * BT_F;
  const long long bhq = static_cast<long long>(bh) * Nq;
  const float* qg = static_cast<const float*>(p.q) + bhq * dqk;
  const float* gg = static_cast<const float*>(p.g) + bhq * dv;
  const float* kg = static_cast<const float*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const float* vg = static_cast<const float*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax = p.bias ? p.bias_max[bh / p.H] : 0.f;
  const uint32_t base = dropout_base(p.seed, static_cast<uint32_t>(bh));
  const int row = q0 + r;
  const float lse = row < Nq ? p.lse[bhq + row] : 0.f;
  const float drow = row < Nq ? p.dsum[bhq + row] : 0.f;

  load_tile_f32<BT_F, THREADS>(Qs, qg, q0, Nq, dqk, ldk, tid);
  load_tile_f32<BT_F, THREADS>(Gs, gg, q0, Nq, dv, ldv, tid);
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BT_F) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are written)
    load_tile_f32<BT_F, THREADS>(Ks, kg, k0, Nk, dqk, ldk, tid);
    load_tile_f32<BT_F, THREADS>(Vs, vg, k0, Nk, dv, ldv, tid);
    __syncthreads();
    for (int jj = 0; jj < BT_F / 4; ++jj) {
      const int kj = c + 4 * jj;
      const int key = k0 + kj;
      float ds = 0.f;
      if (key < Nk && row < Nq) {
        const float pr =
            expf(score_f32(Qs + r * ldk, Ks + kj * ldk, dqk, p.scale, bg, key, bmax) - lse);
        float dp = dot_f32(Gs + r * ldv, Vs + kj * ldv, dv);
        if (p.thr != 0u)
          dp = dropout_keep(base, row, key, p.nk_p, p.thr) ? dp * p.inv_keep : 0.f;
        ds = pr * (dp - drow);
      }
      Ss[r * LDP_F + kj] = ds;
    }
    __syncwarp();  // a query's four threads are in one warp
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c + 4 * j;
      if (col < dqk) {
        float sum = 0.f;
        for (int kj = 0; kj < BT_F; ++kj) sum = fmaf(Ss[r * LDP_F + kj], Ks[kj * ldk + col], sum);
        acc[j] += sum;
      }
    }
  }
  if (row >= Nq) return;
  float* dqg = static_cast<float*>(p.dq) + (bhq + row) * dqk;
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) {
    const int col = c + 4 * j;
    if (col < dqk) dqg[col] = acc[j] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool DROPOUT>
cudaError_t launch_bf16(BwdParams p, int BH, cudaStream_t stream) {
  constexpr int smem = smem_bytes_dkdv<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<DQK, DV, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.tiles = (p.Nk + BK2 - 1) / BK2;
  flash_bwd_dkdv_bf16<DQK, DV, DROPOUT><<<p.tiles * BH, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem_dq = smem_bytes_dq<DQK, DV>();
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16<DQK, DV, DROPOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  p.tiles = (p.Nq + BQ3 - 1) / BQ3;
  flash_bwd_dq_bf16<DQK, DV, DROPOUT><<<p.tiles * BH, THREADS, smem_dq, stream>>>(p);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bf16_drop(const BwdParams& p, int BH, cudaStream_t stream) {
  return p.thr != 0u ? launch_bf16<DQK, DV, true>(p, BH, stream)
                     : launch_bf16<DQK, DV, false>(p, BH, stream);
}

template <int DQK>
cudaError_t launch_bf16_dv(const BwdParams& p, int BH, cudaStream_t stream) {
  return p.dv_ <= 64 ? launch_bf16_drop<DQK, 64>(p, BH, stream)
                     : launch_bf16_drop<DQK, 128>(p, BH, stream);
}

cudaError_t launch_f32(BwdParams p, int BH, cudaStream_t stream) {
  const int smem = smem_bytes_f32(p.dqk, p.dv_);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.tiles = (p.Nk + BT_F - 1) / BT_F;
  flash_bwd_dkdv_f32<<<p.tiles * BH, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.tiles = (p.Nq + BT_F - 1) / BT_F;
  flash_bwd_dq_f32<<<p.tiles * BH, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B*H, Nq, dqk), k (B*H, Nk, dqk),
// v (B*H, Nk, dv), g (B*H, Nq, dv), dk and dv like k and v, all contiguous,
// 16-byte aligned and of the dtype, as is dq (B*H, Nq, dqk); lse and dsum
// (B*H, Nq) float32; bias null or (B, Nk) float32 with bias_max its (B,) row
// maxima; dqk, dv multiples of 16 in [16, 128]; Nq, Nk >= 1. thr = 0 means
// no dropout. The caller checks all of this. Returns the first failing
// launch's cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* dsum, const void* bias,
                                   const void* bias_max, void* dq, void* dk, void* dv, int B,
                                   int H, int Nq, int Nk, int dqk, int dv_, float scale,
                                   unsigned seed, unsigned thr, unsigned nk_p, float inv_keep,
                                   int dtype, void* stream) {
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk < 16 || dqk > DMAX || dqk % 16 || dv_ < 16 || dv_ > DMAX || dv_ % 16 || Nq < 1 ||
      Nk < 1 || (bias != nullptr && bias_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.bias = static_cast<const float*>(bias);
  p.bias_max = static_cast<const float*>(bias_max);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.dqk = dqk;
  p.dv_ = dv_;
  p.tiles = 0;
  p.scale = scale;
  p.seed = seed;
  p.thr = thr;
  p.nk_p = nk_p;
  p.inv_keep = inv_keep;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(p, BH, st);
  } else if (dtype == 1) {
    err = dqk <= 64 ? launch_bf16_dv<64>(p, BH, st) : launch_bf16_dv<128>(p, BH, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
