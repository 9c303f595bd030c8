// Attention forward for NVIDIA Hopper (sm_90a): flash kernels (online
// softmax over key tiles) in bf16 on the tensor cores, through wgmma and TMA
// at the models' head widths and through mma.sync at any other, and a plain
// f32 one on the CUDA cores. The eval call returns o; the train call also
// returns the row log-sum-exp and may apply dropout to the probabilities.
//
// Replaces three TPU kernels of unet_torch_tpu/kernels/attention.py:
// _attention_pallas (the whole sequence of one batch*head per grid cell),
// _attention_flash (online softmax over Nk tiles, taken when the working set
// passes 10 MB of VMEM) and _dropout_flash_fwd (the train forward: online
// softmax, dropout on the normalised probabilities, o and lse). The first two
// differ only in how much of the sequence the TPU's VMEM holds; a Hopper
// block holds at most 227 KB of shared memory, so here every size takes the
// tiled form:
//
//   o[b,h,i,:] = sum_j keep_ij / (1 - rate) * p_ij v[b,h,j,:],
//   p_ij = softmax_j(scale * q[b,h,i,:] . k[b,h,j,:] + bias[b,j] - bmax[b]),
//   lse[b*H+h, i] = log sum_j exp(scale * q . k + bias[b,j] - bmax[b])
//
// keep_ij is the counter hash of dropout_hash.cuh (all ones at rate 0); the
// row sums are taken before dropout, as _dropout_flash_fwd takes them. q, k
// are (B*H, N, Dqk) and v is (B*H, Nk, Dv), contiguous; Dqk and Dv are
// multiples of 16 up to 128 and may differ; Nq, Nk >= 1 are any size. The
// optional bias is (B, Nk) f32 (-1e30 marks padding keys), shared by every
// head and query, and bmax[b] = max_j bias[b,j] is subtracted after it: it
// changes no probability, but a row whose keys are all padding keeps its
// log-sum-exp (log Nk rather than a -1e30 that swallows it), so that the
// backward recomputes its probabilities. Such a row sees equal scores and
// gets the mean of its Nk rows of v, as _attention_pallas gives
// (_attention_flash would also average over its zero-padded columns).
// Columns past Nk get zero weight.
//
// bf16, two kernels; which one a call launches is a function of the head
// widths alone (the wrapper's attention_route):
//
// wgmma design (csrc/flash_fwd_wgmma.cuh, its HEADS = 1 instances; the packed
// two-head probe, csrc/packed2_attention_fwd.cu, is its HEADS = 2 instance),
// compiled at the width pairs (Dqk, Dv) = (64, 64) (the ViT),
// (32, 32) and (64, 32) (CLTR), nothing padded. A block of 288 threads owns
// 128 query rows: two consumer warpgroups of 64 rows each and one producer
// warp, whose first lane keeps a ring of three 64-key K and V tiles in
// flight with TMA loads (3-D tensor maps (D, N, B*H), boxes of (D, 64, 1),
// 128-byte swizzle at D = 64 and 64-byte at D = 32, rows past N arriving as
// zeros) that complete on mbarriers; each consumer warp hands a stage back
// when its products have read it. S = Q K^T is one wgmma m64n64k16 chain with
// both operands read from shared memory; P stays in the accumulator
// registers, is rounded to bf16 there and is the register A operand of
// O += P V, with V read as an MN-major B operand, so nothing is transposed
// in memory and no thread spends an instruction on a copy or a fragment
// load. The accumulator puts rows and columns where mma.sync does, so the
// softmax and the mask carry over with their global (row, column). What the
// softmax costs a score is cut to a maximum, one FMA (the scale folded into
// the exponent), ex2.approx, an add and half a pack: the bias and a scale
// <= 0 take a GENERAL instance, columns past Nk are masked on the last tile
// only, the dropout's 1 / (1 - rate) is applied once to O, and the hash
// starts from a per-row index (dropout_keep_idx). 96 registers a thread and
// 65 KB of shared memory at D = 64 let two blocks, 16 consumer warps, share
// an SM, and their softmax and products overlap as the warp schedulers find
// them. The 96 are the launch bound's doing: two blocks of nine warps put
// five warps on one of the SM's four register files of 16 K, and 16384 / 5
// / 32 = 102 rounds down to 96. At (32, 32) and (64, 32) nothing spills; at
// (64, 64) a thread holds 32 f32 of O, 32 of S, 16 words of packed P and the
// rows' maxima, sums and hash indices, which is 16-48 bytes more than 96
// registers hold: ptxas keeps them on the stack (the build's log says how
// many; the backward at 168 registers spills none). Ordering the two
// warpgroups' turns with named barriers (FlashAttention-3's ping-pong) was
// measured and dropped: with two blocks an SM it changed nothing at width 32
// and cost 2-4% at width 64; one block an SM with 120-147 registers was 27%
// slower at the ViT's shape (PERF.md).
//
// mma.sync design (FlashAttention-2 style), every other width pair: a block
// of 4 warps owns 64 query rows of one batch*head, 16 per warp, and walks the
// keys in tiles of 64 rows.
// K and V tiles are double-buffered in shared memory with cp.async (the next
// tile is in flight while the current one is multiplied; rows past Nk and
// columns past D are zero-filled). S = Q K^T and O += P V run on the tensor
// cores with ldmatrix + mma.sync m16n8k16 and f32 accumulators; the softmax
// runs in f32 registers in the base-2 domain, with the running row maximum
// and sum, and P goes from the S accumulators to the A operand of the second
// product as bf16 without leaving registers. O is divided by the row sum
// once, at the end, and written once. Head widths are padded to 64 or 128 in
// shared memory (zeros add nothing), so four template instances cover every
// width. Dropout is a template flag: the eval and rate-0 train calls compile
// no hash, as the JAX kernel's trace-time thr == 0 does. With dropout each
// probability is masked in registers by the hash of its global (row, col),
// which costs two multiplies and a few shifts per score and stores nothing.
//
// What bounds it on an H100: at the ViT's shape (B*H = 96, N = 1024, D = 64)
// one call is 25.8 GFLOP, 50 MB of q, k, v and o in device memory and 100 M
// exponentials: 0.026 ms of tensor-core work at the card's peak, 0.015 ms of
// device memory and 0.024 ms of the exp unit (16 a clock an SM). At width 32
// (CLTR's decoder self-attention, B*H = 128, N = 2000) the exp unit's 0.12 ms
// is twice the tensor cores' 0.066, and with dropout the hash's eleven
// integer instructions a score cost more than either. The schedulers'
// instruction rate is what the wgmma kernel runs into: about 270
// instructions a 64 x 64 tile and warp, four warps a tile, is 270 cycles an
// SM at best (four schedulers, one instruction a clock each) against the exp
// unit's 256 and the tensor cores' 190. Measured on an NVIDIA H100 80GB HBM3
// at 700 W, launches back to back: 0.082 ms at the ViT's shape (315 TFLOP/s;
// the mma.sync kernel 0.154, scaled_dot_product_attention 0.072), 0.29 ms at
// the decoder self-attention at rate 0 and 0.51 at rate 0.1 (0.73 and 0.88;
// 0.34 and 0.81). The next steps are the next tile's S started before this
// tile's softmax ends (it needs 32 more registers a thread than two blocks
// an SM leave) and a 128-key tile.
//
// f32 design: a block of 128 threads owns 32 query rows, four threads a
// row; key and value tiles of 32 rows go through shared memory, scores and
// the output are summed in full f32 on the CUDA cores, so that the kernel
// can be held against a reference with TF32 off. Speed is not its purpose.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <math_constants.h>

#include "flash_fwd_wgmma.cuh"
#include "flash_tiles.cuh"

namespace {

constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// bf16: mma.sync, any head widths (multiples of 16 up to 128)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block, 16 per warp (key tiles of BKV = 64 rows)

template <int DQK, int DV>
constexpr int smem_bytes_bf16() {
  return (BQ * Pitch<DQK>::LD + 2 * BKV * Pitch<DQK>::LD + 2 * BKV * Pitch<DV>::LD) *
         static_cast<int>(sizeof(bf16));
}

template <int DQK, int DV, bool DROPOUT>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(const FwdParams p) {
  constexpr int LDQ = Pitch<DQK>::LD;
  constexpr int LDV = Pitch<DV>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDQ;       // two tiles
  bf16* Vs = Ks + 2 * BKV * LDQ;  // two tiles

  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator row (and row + 8)
  const int t4 = lane % 4;  // accumulator column pair
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * BQ;
  const bf16* qg = static_cast<const bf16*>(p.q) + static_cast<long long>(bh) * Nq * dqk;
  const bf16* kg = static_cast<const bf16*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const bf16* vg = static_cast<const bf16*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax2 = p.bias ? p.bias_max[bh / p.H] * LOG2E : 0.f;
  const float scale2 = p.scale * LOG2E;  // scores in the base-2 domain
  uint32_t base = 0;
  if constexpr (DROPOUT)
    base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));

  load_tile<BQ, DQK, THREADS>(Qs, qg, q0, Nq, dqk, tid);
  load_tile<BKV, DQK, THREADS>(Ks, kg, 0, Nk, dqk, tid);
  load_tile<BKV, DV, THREADS>(Vs, vg, 0, Nk, dv, tid);
  cp_async_commit();

  uint32_t qf[DQK / 16][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g, g + 8
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int kv_tiles = (Nk + BKV - 1) / BKV;
  for (int t = 0; t < kv_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < kv_tiles) {
      load_tile<BKV, DQK, THREADS>(Ks + (buf ^ 1) * BKV * LDQ, kg, (t + 1) * BKV, Nk, dqk, tid);
      load_tile<BKV, DV, THREADS>(Vs + (buf ^ 1) * BKV * LDV, vg, (t + 1) * BKV, Nk, dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and, at t = 0, the Q tile) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LDQ + kk * 16 + (lane / 16) * 8);
    }
    const bf16* Kt = Ks + buf * BKV * LDQ;
    const bf16* Vt = Vs + buf * BKV * LDV;

    // S = Q K^T: K lies [key][d], which is the column-major B operand as it is
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BKV / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Kt + (j * 8 + (lane / 16) * 8 + lane % 8) * LDQ + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[j], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[j + 1], qf[kk], r[2], r[3]);
      }

    // online softmax: scale, bias, mask columns past Nk, new row maxima
    const int k0 = t * BKV;
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        float x = s[j][e] * scale2;
        // the bias first (a -1e30 swallows the score), then the row shift
        if (bg != nullptr && col < Nk) x = (x + bg[col] * LOG2E) - bmax2;
        x = col < Nk ? x : -CUDART_INF_F;
        s[j][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
      // every tile holds a real key, so m_new is finite; exp2(-inf) = 0
      corr[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[j][e] - m_new[e >> 1]);
        l_run[e >> 1] += pr;  // the row sum is taken before dropout
        if constexpr (DROPOUT) {
          const uint32_t row = p.q_off + q0 + warp * 16 + g + 8 * (e >> 1);
          const uint32_t col = k0 + j * 8 + 2 * t4 + (e & 1);
          pr = dropout_keep(base, row, col, p.nk_p, p.thr) ? pr * p.inv_keep : 0.f;
        }
        s[j][e] = pr;
      }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the S accumulators of two adjacent n8 tiles are the A
    // fragment of one k16 step; V lies [key][d], loaded transposed
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16_16816(acc[j], a, r[0], r[1]);
        mma_bf16_16816(acc[j + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  float l_row[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv[i] = 1.f / l;
  }
  const int row0 = q0 + warp * 16 + g;
  bf16* og = static_cast<bf16*>(p.o) + static_cast<long long>(bh) * Nq * dv;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    if (col >= dv) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Nq)
        *reinterpret_cast<uint32_t*>(og + static_cast<long long>(row) * dv + col) =
            pack_bf16x2(acc[j][2 * i] * inv[i], acc[j][2 * i + 1] * inv[i]);
    }
  }
  if (p.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Nq)
        p.lse[static_cast<long long>(bh) * Nq + row] = (m_run[i] + log2f(l_row[i])) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ_F = 32;   // query rows per block, four threads a row
constexpr int BKV_F = 32;  // key rows per tile
constexpr int DMAX = 128;

inline int smem_bytes_f32(int dqk, int dv) {
  return (2 * BQ_F * (dqk + 1) + BKV_F * (dv + 1) + BQ_F * (BKV_F + 1)) *
         static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(THREADS) flash_fwd_f32(const FwdParams p) {
  const int Nq = p.Nq, Nk = p.Nk, dqk = p.dqk, dv = p.dv;
  // odd pitches keep the four threads of a row and the rows of a warp on
  // different banks
  const int ldk = dqk + 1;
  const int ldv = dv + 1;
  constexpr int LDP = BKV_F + 1;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + BQ_F * ldk;
  float* Vs = Ks + BKV_F * ldk;
  float* Ps = Vs + BKV_F * ldv;

  const int tid = threadIdx.x;
  const int r = tid / 4;  // this thread's query row in the tile
  const int c = tid % 4;  // keys c, c+4, ...; output columns c, c+4, ...
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * BQ_F;
  const float* qg = static_cast<const float*>(p.q) + static_cast<long long>(bh) * Nq * dqk;
  const float* kg = static_cast<const float*>(p.k) + static_cast<long long>(bh) * Nk * dqk;
  const float* vg = static_cast<const float*>(p.v) + static_cast<long long>(bh) * Nk * dv;
  const float* bg = p.bias ? p.bias + static_cast<long long>(bh / p.H) * Nk : nullptr;
  const float bmax = p.bias ? p.bias_max[bh / p.H] : 0.f;
  const uint32_t base = dropout_base(p.seed, dropout_bh(bh, p.H, p.b_off, p.h_off, p.h_total));

  load_tile_f32<BQ_F, THREADS>(Qs, qg, q0, Nq, dqk, ldk, tid);
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BKV_F) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    load_tile_f32<BKV_F, THREADS>(Ks, kg, k0, Nk, dqk, ldk, tid);
    load_tile_f32<BKV_F, THREADS>(Vs, vg, k0, Nk, dv, ldv, tid);
    __syncthreads();

    float x[BKV_F / 4];
    float m_new = m_run;
#pragma unroll
    for (int jj = 0; jj < BKV_F / 4; ++jj) {
      const int key = c + 4 * jj;
      float dot = 0.f;
      for (int d = 0; d < dqk; ++d) dot = fmaf(Qs[r * ldk + d], Ks[key * ldk + d], dot);
      float xv = dot * p.scale;
      if (bg != nullptr && k0 + key < Nk) xv = (xv + bg[k0 + key]) - bmax;
      xv = k0 + key < Nk ? xv : -CUDART_INF_F;
      x[jj] = xv;
      m_new = fmaxf(m_new, xv);
    }
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
    const float corr = expf(m_run - m_new);
    m_run = m_new;
    l_run *= corr;
#pragma unroll
    for (int jj = 0; jj < BKV_F / 4; ++jj) {
      float pr = expf(x[jj] - m_new);
      l_run += pr;  // the row sum is taken before dropout
      if (p.thr != 0u)
        pr = dropout_keep(base, p.q_off + q0 + r, k0 + c + 4 * jj, p.nk_p, p.thr) ? pr * p.inv_keep
                                                                                : 0.f;
      Ps[r * LDP + c + 4 * jj] = pr;
    }
    __syncwarp();  // a row's four threads are in one warp
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int col = c + 4 * j;
      if (col < dv) {
        float sum = 0.f;
        for (int key = 0; key < BKV_F; ++key)
          sum = fmaf(Ps[r * LDP + key], Vs[key * ldv + col], sum);
        acc[j] = acc[j] * corr + sum;
      }
    }
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  const int row = q0 + r;
  if (row >= Nq) return;
  float* og = static_cast<float*>(p.o) + (static_cast<long long>(bh) * Nq + row) * dv;
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) {
    const int col = c + 4 * j;
    if (col < dv) og[col] = acc[j] / l_run;
  }
  if (p.lse != nullptr && c == 0)
    p.lse[static_cast<long long>(bh) * Nq + row] = m_run + logf(l_run);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DQK, int DV, bool DROPOUT>
cudaError_t launch_bf16(const FwdParams& p, int BH, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<DQK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DQK, DV, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<DQK, DV, DROPOUT><<<p.q_tiles * BH, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bf16_drop(const FwdParams& p, int BH, cudaStream_t stream) {
  return p.thr != 0u ? launch_bf16<DQK, DV, true>(p, BH, stream)
                     : launch_bf16<DQK, DV, false>(p, BH, stream);
}

template <int DQK>
cudaError_t launch_bf16_dv(const FwdParams& p, int BH, cudaStream_t stream) {
  return p.dv <= 64 ? launch_bf16_drop<DQK, 64>(p, BH, stream)
                    : launch_bf16_drop<DQK, 128>(p, BH, stream);
}

template <int DQK, int DV>
cudaError_t launch_wgmma_widths(const FwdParams& p, int BH, cudaStream_t stream) {
  // the scale can be folded into the exponent only without a bias and when
  // it keeps the order of the scores
  const bool general = p.bias != nullptr || !(p.scale > 0.f);
  // one head a block (128 query rows), three stages, two blocks an SM
  if (p.thr != 0u)
    return general ? launch_wgmma<DQK, DV, true, true, 1, 3, 2>(p, BH, stream)
                   : launch_wgmma<DQK, DV, false, true, 1, 3, 2>(p, BH, stream);
  return general ? launch_wgmma<DQK, DV, true, false, 1, 3, 2>(p, BH, stream)
                 : launch_wgmma<DQK, DV, false, false, 1, 3, 2>(p, BH, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B*H, Nq, dqk), k (B*H, Nk, dqk),
// v (B*H, Nk, dv) and o (B*H, Nq, dv) are contiguous and 16-byte aligned;
// bias is null or a contiguous (B, Nk) float32 array with bias_max its (B,)
// row maxima; lse is null (eval) or a (B*H, Nq) float32 array; dqk and dv
// are multiples of 16 in [16, 128]; Nq, Nk >= 1. thr = 0 means no dropout;
// otherwise keep = hash >= thr and survivors are scaled by inv_keep; the hash
// keys on the batch*head of the whole batch, b_off, h_off and h_total giving
// this call's place in it (dropout_hash.cuh dropout_bh), and on the query
// row of the whole sequence, q_off + the call's row (a strip of the
// image's tokens starts at q_off). The
// caller checks all of this. route names the kernel: 0 the f32 CUDA-core one
// (dtype 0), 1 the bf16 mma.sync one (any widths), 2 the bf16 wgmma one (the
// width pairs (64, 64), (32, 32) and (64, 32) only); the wrapper derives it
// from the dtype and the widths alone. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                   const void* bias_max, void* o, void* lse, int B, int H, int Nq,
                                   int Nk, int dqk, int dv, float scale, unsigned seed,
                                   unsigned thr, unsigned nk_p, float inv_keep, int b_off,
                                   int h_off, int h_total, int q_off, int dtype, int route,
                                   void* stream) {
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk < 16 || dqk > DMAX || dqk % 16 || dv < 16 || dv > DMAX || dv % 16 || Nq < 1 || Nk < 1 ||
      (bias != nullptr && bias_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.bias_max = static_cast<const float*>(bias_max);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.dqk = dqk;
  p.dv = dv;
  p.scale = scale;
  p.seed = seed;
  p.thr = thr;
  p.nk_p = nk_p;
  p.inv_keep = inv_keep;
  p.b_off = b_off;
  p.h_off = h_off;
  p.h_total = h_total;
  p.q_off = q_off;
  cudaError_t err;
  if (dtype == 0 && route == 0) {
    const int smem = smem_bytes_f32(dqk, dv);
    err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      p.q_tiles = (Nq + BQ_F - 1) / BQ_F;
      flash_fwd_f32<<<p.q_tiles * BH, THREADS, smem, st>>>(p);
      err = cudaGetLastError();
    }
  } else if (dtype == 1 && route == 1) {
    p.q_tiles = (Nq + BQ - 1) / BQ;
    err = dqk <= 64 ? launch_bf16_dv<64>(p, BH, st) : launch_bf16_dv<128>(p, BH, st);
  } else if (dtype == 1 && route == 2) {
    if (dqk == 64 && dv == 64)
      err = launch_wgmma_widths<64, 64>(p, BH, st);
    else if (dqk == 32 && dv == 32)
      err = launch_wgmma_widths<32, 32>(p, BH, st);
    else if (dqk == 64 && dv == 32)
      err = launch_wgmma_widths<64, 32>(p, BH, st);
    else
      err = cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
