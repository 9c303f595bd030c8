// Attention backward for NVIDIA Hopper (sm_90a): in bf16 on the tensor cores,
// one wgmma + TMA kernel at the models' head widths and FlashAttention-2's two
// mma.sync kernels at any other, and a plain f32 form on the CUDA cores.
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
// D = rowsum(g * o) comes first, one thread a row (rowsum_go), for every
// dtype and route. Then, in bf16, which kernels a call launches is a function
// of the head widths alone (the wrapper's attention_route):
//
// wgmma design, compiled at the width pairs (Dqk, Dv) = (64, 64) (the ViT),
// (32, 32) and (64, 32) (CLTR), nothing padded: one kernel for dK, dV and dQ.
// A block of 384 threads owns 128 keys: two consumer warpgroups of 64 keys
// each and a producer warpgroup that gives its registers up (setmaxnreg) and
// of which one warp works: its first lane keeps a ring of three 64-query Q
// and dO tiles in flight with TMA loads that complete on mbarriers (tensor
// maps and swizzles as in the forward; K and V of the block are loaded
// once), its 32 lanes stage the tile's lse and D. S^T = K Q^T and
// dP^T = V dO^T read both operands from shared memory, the keys as rows, so
// that P^T and dS^T sit in the accumulators as the register A operands of
// dV += P^T dO and dK += dS^T Q, whose B operand is the same dO or Q tile
// read MN-major: one Q tile serves S^T and dK, one dO tile dP^T and dV.
// dQ needs a sum over the keys, across blocks: each tile's dS^T also goes to
// shared memory as bf16, [key][query], and dQ_tile = dS K is one more wgmma
// chain with both operands read MN-major (the transpose bits for A and B);
// its f32 result goes through a swizzled shared-memory tile into the f32 dq
// array by a TMA reduce-add (cp.reduce.async.bulk.tensor), started by one
// thread a warpgroup, which clips rows past Nq; a last kernel scales and
// rounds dq to bf16 (scale_cast_dq). The other form, a second kernel that
// walks the keys for each 128 queries and recomputes S, dP and the mask, was
// measured against this one on the card, launches back to back: 0.268
// against 0.268 ms at the ViT's shape at rate 0, 0.356 against 0.335 at rate
// 0.1, 0.881 against 0.748 and 1.277 against 1.006 ms at CLTR's decoder
// self-attention (rates 0 and 0.1), 0.158 against 0.195 at its cross-
// attention (64 keys: one block a batch*head, half of it idle). The
// exponentials and the hash are the bound at width 32 and the one-kernel
// form does them once, so it stays; dq's sum order now varies from run to
// run. The softmax arithmetic is cut as in the forward (scale folded into
// the exponent's FMA, 1 / (1 - rate) applied once to dV). Nothing is masked
// but dS^T's key rows past Nk (they meet zero rows of K, but an inf there
// would give NaN): rows past Nq arrive as zeros with lse = D = 0 and add
// nothing. 168 registers a thread (what 384 threads leave each at launch;
// ptxas stays there after setmaxnreg.inc 240) without spills as
// kernels/build.py compiles it (32-136 bytes at (64, 64) without
// -split-compile), 131 KB of shared memory at D = 64, one block an SM.
//
// mma.sync design, every other width pair, two kernels. dK/dV: a block of 4
// warps owns 64 keys of one
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
// the five products are 64 GFLOP, 0.065 ms at the bf16 peak; the exp unit
// computes 100 M exponentials (0.024 ms); device memory moves q, k, v, o, g,
// dk, dv and the f32 dq twice over (about 190 MB, 0.06 ms). The schedulers'
// instruction rate and latency bound it: about 450 instructions a 64 x 64
// tile and warp, and
// one block's 8 consumer warps an SM cannot hide a wgmma's wait. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W, launches back to back, all three
// kernels: 0.268 ms at the ViT's shape (the mma.sync kernels 0.59,
// scaled_dot_product_attention's backward 0.22), 0.75 ms at CLTR's decoder
// self-attention at rate 0 and 1.01 at rate 0.1 (2.73 and 3.69; 0.87 and
// 1.16). The known next step is to leave dV += and dK += in flight under the
// next tile's S^T and dP^T.
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
#include "hopper_mma.cuh"

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
  float* dq_f32;          // (B*H, Nq, dqk) scratch of the wgmma kernel, or null
  void* dk;
  void* dv;
  int H, Nq, Nk, dqk, dv_, tiles;
  float scale;
  uint32_t seed, thr, nk_p;
  float inv_keep;
  int b_off, h_off, h_total;  // the mask's global batch*head (dropout_bh)
  int q_off;                  // the mask's global row of query row 0
};

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), both dtypes
// ---------------------------------------------------------------------------

// One thread a row: it reads its row of g and of o in 16-byte pieces (whole
// 32-byte sectors), multiplies and sums in f32.
template <typename T>
__global__ void __launch_bounds__(256) rowsum_go(const T* __restrict__ g, const T* __restrict__ o,
                                                 float* __restrict__ dsum, long long rows, int dv) {
  const long long r = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (r >= rows) return;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes
  const uint4* gr = reinterpret_cast<const uint4*>(g + r * dv);
  const uint4* orow = reinterpret_cast<const uint4*>(o + r * dv);
  float sum = 0.f;
  for (int c = 0; c < dv / PER; ++c) {
    const uint4 a = __ldg(gr + c);
    const uint4 b = __ldg(orow + c);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      sum = fmaf(static_cast<float>(av[i]), static_cast<float>(bv[i]), sum);
  }
  dsum[r] = sum;
}

template <typename T>
cudaError_t launch_rowsum(const BwdParams& p, const void* o, float* dsum, int BH,
                          cudaStream_t stream) {
  const long long rows = static_cast<long long>(BH) * p.Nq;
  rowsum_go<T><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(p.g), static_cast<const T*>(o), dsum, rows, p.dv_);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, any head widths (multiples of 16 up to 128)
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
  if constexpr (DROPOUT)
    base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));

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
          if (dropout_keep(base, static_cast<uint32_t>(p.q_off + q0 + qc),
                           static_cast<uint32_t>(key[i]), p.nk_p, p.thr))
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
  if constexpr (DROPOUT)
    base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));

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
          d = dropout_keep(base, static_cast<uint32_t>(p.q_off + row[i]),
                           static_cast<uint32_t>(col), p.nk_p, p.thr)
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
// bf16: wgmma, head widths (64, 64), (32, 32), (64, 32)
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 128;       // keys per block, 64 a consumer warpgroup
constexpr int WG_STAGES = 3;       // query tiles in flight
constexpr int WG_CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // and a producer warpgroup

template <int DQK, int DV>
constexpr int smem_bytes_wgmma() {
  return (2 + WG_STAGES) * (tile_bytes<64, DQK>() + tile_bytes<64, DV>()) +
         2 * (tile_bytes<64, 64>() + 64 * DQK * static_cast<int>(sizeof(float))) +
         WG_STAGES * 2 * 64 * static_cast<int>(sizeof(float)) + 1024 /* alignment */ +
         64 /* barriers */;
}

// dK, dV and dQ: each consumer warpgroup owns 64 keys; the producer streams
// the queries past them in tiles of 64 (Q and dO by TMA, lse and D by its
// lanes). GENERAL: a bias or a scale <= 0; otherwise the scale is folded into
// the exponent's FMA. The design is set out at the head of the file.
template <int DQK, int DV, bool GENERAL, bool DROPOUT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_wgmma(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_dq) {
  constexpr int KB = tile_bytes<64, DQK>();  // a K or Q tile
  constexpr int VB = tile_bytes<64, DV>();   // a V or dO tile
  constexpr int SB = tile_bytes<64, 64>();   // a dS^T tile
  constexpr int HB = 64 * 32 * 4;            // 32 columns of a dQ tile, f32
  constexpr int DQB = (DQK / 32) * HB;
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* Ks = align_1024(wsmem);  // two tiles, one a consumer warpgroup
  unsigned char* Vs = Ks + 2 * KB;        // two tiles
  unsigned char* Qs = Vs + 2 * VB;        // WG_STAGES tiles
  unsigned char* Gs = Qs + WG_STAGES * KB;  // WG_STAGES tiles
  unsigned char* Ss = Gs + WG_STAGES * VB;  // two dS^T tiles
  unsigned char* dQs = Ss + 2 * SB;         // two dQ tiles
  float* Ls = reinterpret_cast<float*>(dQs + 2 * DQB);  // WG_STAGES x 64, lse * log2(e)
  float* Ds = Ls + WG_STAGES * 64;                      // WG_STAGES x 64
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + WG_STAGES * 64);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + WG_STAGES;

  const int Nq = p.Nq, Nk = p.Nk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x % p.tiles) * WG_ROWS;
  const long long bhq = static_cast<long long>(bh) * Nq;
  const int q_tiles = (Nq + 63) / 64;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(full + i, 33);
      mbar_init(empty + i, WG_CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    // the producer warpgroup hands its registers to the consumers; one of
    // its warps works
    setmaxnreg_dec<24>();
    if (warp != WG_CONSUMERS / 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * (KB + VB));
      tma_load_3d(Ks, &map_k, kv_full, 0, k0, bh);
      tma_load_3d(Ks + KB, &map_k, kv_full, 0, k0 + 64, bh);
      tma_load_3d(Vs, &map_v, kv_full, 0, k0, bh);
      tma_load_3d(Vs + VB, &map_v, kv_full, 0, k0 + 64, bh);
    }
    for (int t = 0; t < q_tiles; ++t) {
      const int stage = t % WG_STAGES;
      mbar_wait(empty + stage, ((t / WG_STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + stage, KB + VB);
        tma_load_3d(Qs + stage * KB, &map_q, full + stage, 0, t * 64, bh);
        tma_load_3d(Gs + stage * VB, &map_g, full + stage, 0, t * 64, bh);
      }
#pragma unroll
      for (int i = lane; i < 64; i += 32) {
        const int q = t * 64 + i;
        Ls[stage * 64 + i] = q < Nq ? p.lse[bhq + q] * LOG2E : 0.f;
        Ds[stage * 64 + i] = q < Nq ? p.dsum[bhq + q] : 0.f;
      }
      mbar_arrive(full + stage);
    }
    return;
  }

  // consumers
  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const float scale2 = p.scale * LOG2E;
  uint32_t folded = 0;
  if constexpr (DROPOUT)
    folded = dropout_fold(dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total)));

  int key[2];
  float bx[2] = {0.f, 0.f};
  const float bmax2 = p.bias ? p.bias_max[bh / p.H] * LOG2E : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + wg * 64 + w * 16 + g + 8 * i;
    if (p.bias != nullptr && key[i] < Nk)
      bx[i] = p.bias[static_cast<long long>(bh / p.H) * Nk + key[i]] * LOG2E;
  }
  const bool ragged = k0 + wg * 64 + 64 > Nk;  // this warpgroup holds rows past Nk
  const unsigned char* Kw = Ks + wg * KB;
  const unsigned char* Vw = Vs + wg * VB;
  unsigned char* Sw = Ss + wg * SB;
  unsigned char* dQw = dQs + wg * DQB;
  const bool elected = w == 0 && lane == 0;  // starts this warpgroup's reduce-adds

  float dk[DQK / 2], dvacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dvacc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < q_tiles; ++t) {
    const int stage = t % WG_STAGES;
    mbar_wait(full + stage, (t / WG_STAGES) & 1);
    const unsigned char* Qt = Qs + stage * KB;
    const unsigned char* Gt = Gs + stage * VB;
    const float* Lt = Ls + stage * 64;
    const float* Dt = Ds + stage * 64;

    float st[32], ds[32];
    wgmma_fence();
    wgmma_ss_tile<DQK>(st, Kw, Qt);
    wgmma_ss_tile<DV>(ds, Vw, Gt);
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(st);
    keep_regs(ds);

    uint32_t idx0[2] = {0u, 0u};
    if constexpr (DROPOUT) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        idx0[i] = static_cast<uint32_t>(p.q_off + t * 64 + 2 * t4) * p.nk_p +
                  static_cast<uint32_t>(key[i]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + j * 8 + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + j * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float l = (e & 1) ? l2.y : l2.x;
        const float d = (e & 1) ? d2.y : d2.x;
        float pr;
        if constexpr (GENERAL) {
          float x = st[4 * j + e] * scale2;
          if (p.bias != nullptr) x = (x + bx[i]) - bmax2;
          pr = fast_exp2(x - l);
        } else {
          pr = fast_exp2(fmaf(st[4 * j + e], scale2, -l));
        }
        float pd = pr;
        float dp = ds[4 * j + e];
        if constexpr (DROPOUT) {
          const bool keep = dropout_keep_idx(
              folded, idx0[i] + static_cast<uint32_t>(j * 8 + (e & 1)) * p.nk_p, p.thr);
          pd = keep ? pr : 0.f;
          dp = keep ? dp * p.inv_keep : 0.f;
        }
        st[4 * j + e] = pd;
        ds[4 * j + e] = pr * (dp - d);
      }
    }
    if (ragged) {
      // a key row past Nk has K = 0, so its pr = exp2(-lse) may be inf: its
      // rows of P^T and dS^T are zeroed (dq sums over every key row of the
      // tile, and inf times K's zeros there would be NaN)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key[e >> 1] >= Nk) st[4 * j + e] = ds[4 * j + e] = 0.f;
    }

    uint32_t pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, ds);
    // dS^T as bf16 into shared memory, [key][query]: da's words are the
    // pairs (row g + 8 i, columns 8 j + 2 t4, + 1) with j = 2 kc + h
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(Sw + Swizzle<64>::offset(w * 16 + g + 8 * i, 2 * kc + h) +
                                       4 * t4) = da[kc][2 * h + i];
    // the last tile's reduce-add has read the dQ tile before anyone rewrites it
    if (elected) bulk_wait_read();
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    float dqp[DQK / 2];
    wgmma_fence();
    wgmma_rs_tile<DV>(dvacc, pa, Gt);
    wgmma_rs_tile<DQK>(dk, da, Qt);
    wgmma_ss_mn_tile<DQK>(dqp, Sw, Kw);
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(dvacc);
    keep_regs(dk);
    keep_regs(dqp);
    keep_regs(pa);
    keep_regs(da);
    if (lane == 0) mbar_arrive(empty + stage);

    // dQ tile: f32 into shared memory (32-column halves, swizzled), then one
    // thread adds it into the dq array
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = (j % 4) * 8 + 2 * t4;  // column within the half
        *reinterpret_cast<float2*>(dQw + (j / 4) * HB +
                                   Swizzle<64>::offset(w * 16 + g + 8 * i, c / 4) + (c % 4) * 4) =
            make_float2(dqp[4 * j + 2 * i], dqp[4 * j + 2 * i + 1]);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (elected) {
#pragma unroll
      for (int half = 0; half < DQK / 32; ++half)
        tma_reduce_add_3d(&map_dq, dQw + half * HB, half * 32, t * 64, bh);
      bulk_commit();
    }
  }
  if (elected) bulk_wait_read();

  const float dv_scale = DROPOUT ? p.inv_keep : 1.f;
  bf16* dkg = static_cast<bf16*>(p.dk) + static_cast<long long>(bh) * Nk * DQK;
  bf16* dvg = static_cast<bf16*>(p.dv) + static_cast<long long>(bh) * Nk * DV;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Nk) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<uint32_t*>(dkg + static_cast<long long>(key[i]) * DQK + j * 8 + 2 * t4) =
          pack_bf16x2(dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(dvg + static_cast<long long>(key[i]) * DV + j * 8 + 2 * t4) =
          pack_bf16x2(dvacc[4 * j + 2 * i] * dv_scale, dvacc[4 * j + 2 * i + 1] * dv_scale);
  }
}

// dq (bf16) = scale * the f32 sums of flash_bwd_wgmma, eight values a
// thread.
__global__ void __launch_bounds__(256) scale_cast_dq(const float* __restrict__ src,
                                                     bf16* __restrict__ dst, long long n8,
                                                     float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = __ldg(reinterpret_cast<const float4*>(src) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 2 * i + 1);
  uint4 out;
  out.x = pack_bf16x2(a.x * scale, a.y * scale);
  out.y = pack_bf16x2(a.z * scale, a.w * scale);
  out.z = pack_bf16x2(b.x * scale, b.y * scale);
  out.w = pack_bf16x2(b.z * scale, b.w * scale);
  reinterpret_cast<uint4*>(dst)[i] = out;
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
  const uint32_t base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));
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
          const bool keep = dropout_keep(base, p.q_off + q0 + qi, key, p.nk_p, p.thr);
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
  const uint32_t base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));
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
          dp = dropout_keep(base, p.q_off + row, key, p.nk_p, p.thr) ? dp * p.inv_keep : 0.f;
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

template <int DQK, int DV, bool GENERAL, bool DROPOUT>
cudaError_t launch_wgmma(BwdParams p, int BH, cudaStream_t stream) {
  CUtensorMap map_q, map_g, map_k, map_v, map_dq;
  cudaError_t err;
  if (p.dq_f32 == nullptr) return cudaErrorInvalidValue;
  if ((err = make_tile_map<DQK>(&map_q, p.q, p.Nq, BH)) != cudaSuccess) return err;
  if ((err = make_tile_map<DV>(&map_g, p.g, p.Nq, BH)) != cudaSuccess) return err;
  if ((err = make_tile_map<DQK>(&map_k, p.k, p.Nk, BH)) != cudaSuccess) return err;
  if ((err = make_tile_map<DV>(&map_v, p.v, p.Nk, BH)) != cudaSuccess) return err;
  if ((err = make_f32_map(&map_dq, p.dq_f32, DQK, p.Nq, BH)) != cudaSuccess) return err;
  const long long n = static_cast<long long>(BH) * p.Nq * DQK;
  if ((err = cudaMemsetAsync(p.dq_f32, 0, n * sizeof(float), stream)) != cudaSuccess) return err;
  constexpr int smem = smem_bytes_wgmma<DQK, DV>();
  auto kernel = flash_bwd_wgmma<DQK, DV, GENERAL, DROPOUT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.tiles = (p.Nk + WG_ROWS - 1) / WG_ROWS;
  kernel<<<p.tiles * BH, WG_THREADS, smem, stream>>>(p, map_q, map_g, map_k, map_v, map_dq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scale_cast_dq<<<static_cast<unsigned>((n / 8 + 255) / 256), 256, 0, stream>>>(
      p.dq_f32, static_cast<bf16*>(p.dq), n / 8, p.scale);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_wgmma_widths(const BwdParams& p, int BH, cudaStream_t stream) {
  // the scale can be folded into the exponent only without a bias and when
  // it keeps the order of the scores
  const bool general = p.bias != nullptr || !(p.scale > 0.f);
  if (p.thr != 0u)
    return general ? launch_wgmma<DQK, DV, true, true>(p, BH, stream)
                   : launch_wgmma<DQK, DV, false, true>(p, BH, stream);
  return general ? launch_wgmma<DQK, DV, true, false>(p, BH, stream)
                 : launch_wgmma<DQK, DV, false, false>(p, BH, stream);
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
// v (B*H, Nk, dv), o and g (B*H, Nq, dv), dk and dv like k and v, all
// contiguous, 16-byte aligned and of the dtype, as is dq (B*H, Nq, dqk); lse
// (B*H, Nq) float32 and dsum a (B*H, Nq) float32 scratch array that the first
// kernel fills with D = rowsum(g * o); bias null or (B, Nk) float32 with
// bias_max its (B,) row maxima; dqk, dv multiples of 16 in [16, 128]; Nq,
// Nk >= 1. thr = 0 means no dropout; b_off, h_off and h_total place the
// call's batch*heads in the whole batch for the mask's hash (dropout_bh),
// q_off its query rows in the whole sequence (the hash's row). The
// caller checks all of this. route
// names the kernels: 0 the f32 CUDA-core pair (dtype 0), 1 the bf16 mma.sync
// pair (any widths), 2 the bf16 wgmma kernel (the width pairs (64, 64),
// (32, 32) and (64, 32) only), which also needs dq_f32, a (B*H, Nq, dqk)
// float32 scratch array (null on the other routes); the wrapper derives the
// route from the dtype and the widths alone. Returns the first failing
// launch's cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const void* lse, void* dsum, const void* bias,
                                   const void* bias_max, void* dq, void* dk, void* dv,
                                   void* dq_f32, int B, int H, int Nq, int Nk, int dqk, int dv_,
                                   float scale, unsigned seed, unsigned thr, unsigned nk_p,
                                   float inv_keep, int b_off, int h_off, int h_total, int q_off,
                                   int dtype, int route, void* stream) {
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
  p.dq_f32 = static_cast<float*>(dq_f32);
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
  p.b_off = b_off;
  p.h_off = h_off;
  p.h_total = h_total;
  p.q_off = q_off;
  cudaError_t err = dtype == 0 ? launch_rowsum<float>(p, o, static_cast<float*>(dsum), BH, st)
                               : launch_rowsum<bf16>(p, o, static_cast<float*>(dsum), BH, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0 && route == 0) {
    err = launch_f32(p, BH, st);
  } else if (dtype == 1 && route == 1) {
    err = dqk <= 64 ? launch_bf16_dv<64>(p, BH, st) : launch_bf16_dv<128>(p, BH, st);
  } else if (dtype == 1 && route == 2) {
    if (dqk == 64 && dv_ == 64)
      err = launch_wgmma_widths<64, 64>(p, BH, st);
    else if (dqk == 32 && dv_ == 32)
      err = launch_wgmma_widths<32, 32>(p, BH, st);
    else if (dqk == 64 && dv_ == 32)
      err = launch_wgmma_widths<64, 32>(p, BH, st);
    else
      err = cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
