// Fused 3x3 SAME convolution + folded BatchNorm + ReLU for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel unet_torch_tpu/kernels/fused_conv.py::
// fused_conv3x3_bn_relu_pallas (and its column-packed variant _v2, which
// computes the same function):
//
//   y[b,h,w,o] = max(0, scale[o] * sum_{dy,dx,c} x[b,h+dy-1,w+dx-1,c] * w[dy,dx,c,o] + bias[o])
//
// x and y are NHWC, f32 or bf16; the weight is HWIO, which is a row-major
// (9*Cin, Cout) matrix as it lies in memory; scale and bias are f32. Taps
// outside the image read zero. The sum is kept in f32, the epilogue runs in
// f32 and the result is rounded once to x's dtype.
//
// Design: an implicit GEMM. The B*H*W output pixels are the GEMM's M, Cout
// its N and the 9*Cin taps its K, ordered (dy, dx, c) so that the HWIO weight
// is the B operand with no reordering. A block of 256 threads owns a
// 128-pixel x BN-channel output tile and walks K in steps of 32, gathering a
// 128x32 slice of the virtual im2col matrix straight from x (zero for halo
// taps and for rows past the end) and a 32xBN slice of the weight into
// shared memory. The epilogue applies scale, bias and ReLU in f32 and writes
// y once, with 16-byte stores where Cout allows; no intermediate goes to
// device memory.
//
// Two mainloops, chosen by what the shapes allow:
//  - bf16 with Cin and Cout multiples of 8 (every conv of the UNet but the
//    first): 16-byte cp.async copies, four shared-memory stages in flight
//    (one barrier per K step), BN = 128 with 64x32 warp tiles when
//    Cout > 64, else BN = 64 with 32x32 warp tiles. Products on the tensor
//    cores with ldmatrix + mma.sync m16n8k16 (bf16 in, f32 accumulate).
//    The stages take 59-74 KB of dynamic shared memory, so the launch raises
//    the 48 KB default with cudaFuncSetAttribute.
//  - everything else (the first conv's Cin = 3, ragged Cout, and f32): loads
//    through registers, the next K step fetched while the current one is
//    multiplied, BN = 64; bf16 on mma.sync, f32 in full f32 on the CUDA cores, so
//    that it can be held against a reference with TF32 off. A channel count
//    that is not a multiple of one 16-byte vector takes scalar loads.
// Odd H and W need nothing special: pixels are addressed one by one along M.
//
// What bounds it on an H100: at the deep levels (H <= 128, Cin >= 128) the
// tensor-core FLOPs, 2*9*Cin per output value against a few bytes moved. At
// the 512x512 level the bytes: the first conv (Cin = 3) does 27 MACs per
// output value and is bound by writing the 64-channel bf16 output, and the
// Cin = 64 convs sit near the card's ridge point (about 290 FLOP per byte if
// x is read once). The design answers the FLOPs with the tensor cores fed by
// a multi-stage copy pipeline, and the bytes by never materialising the
// im2col matrix and by writing y once; the nine-fold reuse of each x value
// across taps is left to L1 and L2. Staging the halo'd input tile once per
// block, wgmma, TMA and a persistent schedule are the known next steps.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <type_traits>

#include "warp_mma.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BK = 32;   // taps x input channels per K step
constexpr int THREADS = 256;
constexpr int STAGES = 4;  // shared-memory stages of the cp.async mainloop

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ uint4 zero_of<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

// The output pixels (A rows) one thread gathers: ITERS rows, ROWS_PER_ITER
// apart, each as (offset of its image in x, h, w).
template <int ITERS, int ROWS_PER_ITER>
struct PixelRows {
  long long img[ITERS];
  int ph[ITERS], pw[ITERS];

  __device__ __forceinline__ void init(int row0, int m0, int M, int H, int W, int Cin) {
    const int HW = H * W;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int m = m0 + row0 + it * ROWS_PER_ITER;
      if (m < M) {
        const int b = m / HW;
        const int r = m - b * HW;
        ph[it] = r / W;
        pw[it] = r - ph[it] * W;
        img[it] = static_cast<long long>(b) * HW * Cin;
      } else {
        ph[it] = -4;  // every tap of a row past the end lands outside the image
        pw[it] = -4;
        img[it] = 0;
      }
    }
  }

  // Element offset in x of row `it`'s tap (dy, dx), channel c, or -1 where
  // the tap reads padding.
  __device__ __forceinline__ long long offset(int it, bool k_in, int dy, int dx, int c, int H,
                                              int W, int Cin) const {
    const int hh = ph[it] + dy - 1;
    const int ww = pw[it] + dx - 1;
    if (!k_in || hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
    return img[it] + (static_cast<long long>(hh) * W + ww) * Cin + c;
  }
};

// bf16 products on the tensor cores with mma.sync: 8 warps as
// WARPS_M x WARPS_N, each warp a (16*FM) x 32 tile of m16n8k16 products with
// f32 accumulators. A is row-major in shared memory ([m][k], LDA), B is
// [k][n] (LDB), so B fragments are loaded transposed.
template <int BN, int WARPS_N>
struct MmaBf16 {
  static constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  static constexpr int FM = BM / WARPS_M / 16;  // m16 tiles per warp
  static constexpr int FN = BN / WARPS_N / 8;   // n8 tiles per warp
  static_assert(FN % 2 == 0, "B fragments are loaded in pairs");
  static constexpr int LDC = BN + 4;
  static constexpr int EPI_BYTES = BM * LDC * sizeof(float);

  float acc[FM][FN][4];
  int wm, wn, lane;

  __device__ __forceinline__ void init(int tid) {
    const int warp = tid / 32;
    lane = tid % 32;
    wm = (warp % WARPS_M) * FM * 16;
    wn = (warp / WARPS_M) * FN * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  template <int LDA, int LDB>
  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[FM][4];
      uint32_t b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(a[i], As + (wm + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < FN; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB + wn + j * 8 + (lane / 16) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // Accumulators go through shared memory (reusing the tiles, which every
  // warp has finished reading) so that each thread can write whole 16-byte
  // runs of one output row.
  template <bool NVEC>
  __device__ __forceinline__ void epilogue(unsigned char* smem, int tid, int m0, int n0, int M,
                                           int Cout, const float* __restrict__ scale,
                                           const float* __restrict__ bias, bf16* __restrict__ y) {
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int r = wm + i * 16 + lane / 4;
        const int c = wn + j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(Cs + r * LDC + c) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(Cs + (r + 8) * LDC + c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();
    constexpr int V = NVEC ? 8 : 1;
    constexpr int PER_ROW = BN / V;
    constexpr int ROWS_PER_ITER = THREADS / PER_ROW;
    const int col = (tid % PER_ROW) * V;
    const int n = n0 + col;
    if (n >= Cout) return;
    float s[V], t[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] = scale[n + e];
      t[e] = bias[n + e];
    }
#pragma unroll 4
    for (int row = tid / PER_ROW; row < BM; row += ROWS_PER_ITER) {
      const int m = m0 + row;
      if (m >= M) break;
      const float* c = Cs + row * LDC + col;
      bf16* dst = y + static_cast<long long>(m) * Cout + n;
      if constexpr (NVEC) {
        uint4 v;
        v.x = pack_bf16x2(relu(c[0] * s[0] + t[0]), relu(c[1] * s[1] + t[1]));
        v.y = pack_bf16x2(relu(c[2] * s[2] + t[2]), relu(c[3] * s[3] + t[3]));
        v.z = pack_bf16x2(relu(c[4] * s[4] + t[4]), relu(c[5] * s[5] + t[5]));
        v.w = pack_bf16x2(relu(c[6] * s[6] + t[6]), relu(c[7] * s[7] + t[7]));
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        *dst = __float2bfloat16(relu(c[0] * s[0] + t[0]));
      }
    }
  }
};

// f32 products on the CUDA cores: each thread an 8x4 register tile, rows
// tm + 16*i, columns 4*tn..+3 of a 128x64 block tile.
struct FmaF32 {
  static constexpr int EPI_BYTES = 0;

  float acc[8][4];
  int tm, tn;

  __device__ __forceinline__ void init(int tid) {
    tm = tid % 16;
    tn = tid / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  template <int LDA, int LDB>
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * LDB + tn * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(tm + 16 * i) * LDA + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }

  template <bool NVEC>
  __device__ __forceinline__ void epilogue(unsigned char*, int, int m0, int n0, int M, int Cout,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float* __restrict__ y) {
    const int n = n0 + tn * 4;
    if (n >= Cout) return;
    float s[4], t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = n + e < Cout ? scale[n + e] : 0.f;
      t[e] = n + e < Cout ? bias[n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tm + 16 * i;
      if (m >= M) break;
      float* dst = y + static_cast<long long>(m) * Cout + n;
      if constexpr (NVEC) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(relu(acc[i][0] * s[0] + t[0]), relu(acc[i][1] * s[1] + t[1]),
                        relu(acc[i][2] * s[2] + t[2]), relu(acc[i][3] * s[3] + t[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < Cout) dst[e] = relu(acc[i][e] * s[e] + t[e]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Mainloop 1: loads through registers, BN = 64; any dtype and channel count.
// ---------------------------------------------------------------------------

constexpr int BN_REG = 64;

// AVEC: Cin is a multiple of one 16-byte vector, so each vector of K lies
// inside one tap and is contiguous in x. NVEC: the same for Cout, for weight
// loads and output stores.
template <typename T, bool AVEC, bool NVEC>
struct RegTile {
  static constexpr int PAD = 16 / sizeof(T);  // rows stay 16-byte aligned
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN_REG + PAD;
  static constexpr int VA = AVEC ? 16 / sizeof(T) : 1;
  static constexpr int VB = NVEC ? 16 / sizeof(T) : 1;
  static constexpr int A_PER_ROW = BK / VA;
  static constexpr int A_ROWS_PER_ITER = THREADS / A_PER_ROW;
  static constexpr int A_ITERS = BM / A_ROWS_PER_ITER;
  static constexpr int B_PER_ROW = BN_REG / VB;
  static constexpr int B_ROWS_PER_ITER = THREADS / B_PER_ROW;
  static constexpr int B_ITERS = BK / B_ROWS_PER_ITER;
  static constexpr int AB_BYTES = (BM * LDA + BK * LDB) * sizeof(T);
};

// Gathers one K step of A (implicit im2col of x) and B (the weight) into
// registers, then stores them to shared memory.
template <typename T, bool AVEC, bool NVEC>
struct RegLoader {
  using TL = RegTile<T, AVEC, NVEC>;
  using VA_t = typename std::conditional<AVEC, uint4, T>::type;
  using VB_t = typename std::conditional<NVEC, uint4, T>::type;

  const T* x;
  const T* w;
  int H, W, Cin, Cout, K, n0;
  int a_row, a_k;  // first A row of this thread, and its k offset in a step
  int b_k, b_n;    // first B row of this thread, and its column
  PixelRows<TL::A_ITERS, TL::A_ROWS_PER_ITER> rows;
  VA_t ra[TL::A_ITERS];
  VB_t rb[TL::B_ITERS];

  __device__ __forceinline__ void init(const T* x_, const T* w_, int H_, int W_, int Cin_,
                                       int Cout_, int tid, int m0, int n0_, int M) {
    x = x_;
    w = w_;
    H = H_;
    W = W_;
    Cin = Cin_;
    Cout = Cout_;
    K = 9 * Cin_;
    n0 = n0_;
    a_row = tid / TL::A_PER_ROW;
    a_k = (tid % TL::A_PER_ROW) * TL::VA;
    b_k = tid / TL::B_PER_ROW;
    b_n = (tid % TL::B_PER_ROW) * TL::VB;
    rows.init(a_row, m0, M, H, W, Cin);
  }

  __device__ __forceinline__ void fetch(int k0) {
    const int k = k0 + a_k;
    const bool k_in = k < K;
    const int tap = k_in ? k / Cin : 0;
    const int c = k - tap * Cin;
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
#pragma unroll
    for (int it = 0; it < TL::A_ITERS; ++it) {
      const long long off = rows.offset(it, k_in, dy, dx, c, H, W, Cin);
      ra[it] = off >= 0 ? *reinterpret_cast<const VA_t*>(x + off) : zero_of<VA_t>();
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int it = 0; it < TL::B_ITERS; ++it) {
      const int kb = k0 + b_k + it * TL::B_ROWS_PER_ITER;
      rb[it] = kb < K && n < Cout
                   ? *reinterpret_cast<const VB_t*>(w + static_cast<long long>(kb) * Cout + n)
                   : zero_of<VB_t>();
    }
  }

  __device__ __forceinline__ void store(T* As, T* Bs) const {
#pragma unroll
    for (int it = 0; it < TL::A_ITERS; ++it) {
      *reinterpret_cast<VA_t*>(As + (a_row + it * TL::A_ROWS_PER_ITER) * TL::LDA + a_k) = ra[it];
    }
#pragma unroll
    for (int it = 0; it < TL::B_ITERS; ++it) {
      *reinterpret_cast<VB_t*>(Bs + (b_k + it * TL::B_ROWS_PER_ITER) * TL::LDB + b_n) = rb[it];
    }
  }
};

template <typename T, bool AVEC, bool NVEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_bn_relu_reg(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        T* __restrict__ y, int M, int H, int W, int Cin, int Cout) {
  using TL = RegTile<T, AVEC, NVEC>;
  using Acc = typename std::conditional<std::is_same<T, float>::value, FmaF32,
                                        MmaBf16<BN_REG, 2>>::type;
  constexpr int SMEM = TL::AB_BYTES > Acc::EPI_BYTES ? TL::AB_BYTES : Acc::EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * TL::LDA;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN_REG;
  const int K = 9 * Cin;

  RegLoader<T, AVEC, NVEC> ld;
  ld.init(x, w, H, W, Cin, Cout, tid, m0, n0, M);
  Acc acc;
  acc.init(tid);

  ld.fetch(0);
  ld.store(As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) ld.fetch(k0 + BK);
    acc.template step<TL::LDA, TL::LDB>(As, Bs);
    __syncthreads();
    if (more) {
      ld.store(As, Bs);
      __syncthreads();
    }
  }
  acc.template epilogue<NVEC>(smem, tid, m0, n0, M, Cout, scale, bias, y);
}

// ---------------------------------------------------------------------------
// Mainloop 2: bf16, Cin and Cout multiples of 8, STAGES cp.async stages.
// ---------------------------------------------------------------------------

template <int BN>
struct PipeTile {
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int A_PER_ROW = BK / 8;
  static constexpr int A_ROWS_PER_ITER = THREADS / A_PER_ROW;
  static constexpr int A_ITERS = BM / A_ROWS_PER_ITER;
  static constexpr int B_PER_ROW = BN / 8;
  static constexpr int B_ROWS_PER_ITER = THREADS / B_PER_ROW;
  static constexpr int B_ITERS = BK / B_ROWS_PER_ITER;
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * static_cast<int>(sizeof(bf16));
  static constexpr int EPI_BYTES = BM * (BN + 4) * static_cast<int>(sizeof(float));
  static constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
};

template <int BN>
__global__ void __launch_bounds__(THREADS)
    conv3x3_bn_relu_pipe(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         bf16* __restrict__ y, int M, int H, int W, int Cin, int Cout) {
  using TL = PipeTile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int KT = (K + BK - 1) / BK;

  const int a_row = tid / TL::A_PER_ROW;
  const int a_k = (tid % TL::A_PER_ROW) * 8;
  const int b_k = tid / TL::B_PER_ROW;
  const int b_n = (tid % TL::B_PER_ROW) * 8;
  PixelRows<TL::A_ITERS, TL::A_ROWS_PER_ITER> rows;
  rows.init(a_row, m0, M, H, W, Cin);

  // Queue the copies of K step kt into stage s.
  auto load_stage = [&](int s, int kt) {
    bf16* As = tiles + s * TL::STAGE_ELEMS;
    bf16* Bs = As + TL::A_ELEMS;
    const int k0 = kt * BK;
    const int k = k0 + a_k;
    const bool k_in = k < K;
    const int tap = k_in ? k / Cin : 0;
    const int c = k - tap * Cin;
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
#pragma unroll
    for (int it = 0; it < TL::A_ITERS; ++it) {
      const long long off = rows.offset(it, k_in, dy, dx, c, H, W, Cin);
      cp_async_16(As + (a_row + it * TL::A_ROWS_PER_ITER) * TL::LDA + a_k,
                  off >= 0 ? x + off : x, off >= 0);
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int it = 0; it < TL::B_ITERS; ++it) {
      const int kb = k0 + b_k + it * TL::B_ROWS_PER_ITER;
      const bool ok = kb < K && n < Cout;
      cp_async_16(Bs + (b_k + it * TL::B_ROWS_PER_ITER) * TL::LDB + b_n,
                  ok ? w + static_cast<long long>(kb) * Cout + n : w, ok);
    }
  };

  MmaBf16<BN, BN / 32> acc;
  static_assert(decltype(acc)::EPI_BYTES <= TL::SMEM_BYTES, "epilogue fits the stages");
  acc.init(tid);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // step kt has landed for this thread; the barrier makes it every
    // thread's, and frees the stage step kt-1 was read from
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_async_commit();
    const bf16* As = tiles + (kt % STAGES) * TL::STAGE_ELEMS;
    acc.template step<TL::LDA, TL::LDB>(As, As + TL::A_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();
  acc.template epilogue<true>(smem, tid, m0, n0, M, Cout, scale, bias, y);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, bool AVEC, bool NVEC>
cudaError_t launch_reg(const void* x, const void* w, const float* scale, const float* bias,
                       void* y, int M, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (Cout + BN_REG - 1) / BN_REG);
  conv3x3_bn_relu_reg<T, AVEC, NVEC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias, static_cast<T*>(y), M, H, W,
      Cin, Cout);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_pipe(const void* x, const void* w, const float* scale, const float* bias,
                        void* y, int M, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  constexpr int smem = PipeTile<BN>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bn_relu_pipe<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_bn_relu_pipe<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias, static_cast<bf16*>(y),
      M, H, W, Cin, Cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg_any(const void* x, const void* w, const float* scale, const float* bias,
                           void* y, int M, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool avec = Cin % V == 0;
  const bool nvec = Cout % V == 0;
  if (avec && nvec) return launch_reg<T, true, true>(x, w, scale, bias, y, M, H, W, Cin, Cout, stream);
  if (avec) return launch_reg<T, true, false>(x, w, scale, bias, y, M, H, W, Cin, Cout, stream);
  if (nvec) return launch_reg<T, false, true>(x, w, scale, bias, y, M, H, W, Cin, Cout, stream);
  return launch_reg<T, false, false>(x, w, scale, bias, y, M, H, W, Cin, Cout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, w and y are 16-byte aligned and
// contiguous; B*H*W < 2^31. The caller checks all of this. Returns the
// launch's cudaError_t.
extern "C" int fused_conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                                     const void* bias, void* y, int B, int H, int W, int Cin,
                                     int Cout, int dtype, void* stream) {
  const int M = B * H * W;
  const float* s = static_cast<const float*>(scale);
  const float* t = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_reg_any<float>(x, w, s, t, y, M, H, W, Cin, Cout, st);
  } else if (dtype == 1) {
    if (Cin % 8 == 0 && Cout % 8 == 0)
      err = Cout > 64 ? launch_pipe<128>(x, w, s, t, y, M, H, W, Cin, Cout, st)
                      : launch_pipe<64>(x, w, s, t, y, M, H, W, Cin, Cout, st);
    else
      err = launch_reg_any<bf16>(x, w, s, t, y, M, H, W, Cin, Cout, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_conv3x3_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
