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
// is the B operand with no reordering. A block owns a 128-pixel x BN-channel
// output tile; the im2col matrix is never materialised, the epilogue applies
// scale, bias and ReLU in f32 and y is written once.
//
// Four mainloops; kernels/fused_conv.py::conv_route picks one from the
// dtype and the channel counts alone, and the entry point refuses a route
// that cannot serve the call:
//  - "wgmma" (bf16, Cin a multiple of 64, Cout of 16: every conv of the UNet
//    family but the first and every TransUnet decoder conv but the last): a
//    persistent, warp-specialised kernel. The 128 pixels are an Ht x Wt
//    rectangle of one image (Wt a power of two up to 64, Ht = 128 / Wt).
//    A producer warpgroup's thread keeps two rings full with TMA: x, per
//    tap and 64 input channels one 4-D box at (c, w0+dx-1, h0+dy-1, b), or,
//    where the tile is 2 x 64 and BN <= 128 (W >= 64, Cout <= 128: the
//    UNet's 512x512 and 256x256 levels), the tile's halo of 4 x 66 pixels
//    once per 64 channels, whose nine taps are 64-row windows of it;
//    out-of-bounds parts (the padding, the image edge, the ragged last tile)
//    arrive as zeros; and the weight in 64-column 2-D boxes. Two consumer warpgroups (64 pixel rows each)
//    run wgmma m64nBNk16 with A K-major and the weight MN-major through the
//    transpose bit, and write their halves of the tile with 4-D TMA stores,
//    which clip what lies past H, W and Cout. One block an SM, two at BN = 64
//    with the halo (one block's epilogue under the other's products). BN =
//    64 for Cout <= 64, 128 for Cout <= 128, else 256:
//    the fewest re-reads of the image rows from L2 (each pixel tile's boxes
//    are read once per N tile), and the 128-pixel tiles keep the waves full
//    at the deep levels (at (H, Cin, Cout) = (32, 1024, 1024), batch 8: 64
//    pixel tiles, 256 tiles, 1.94 waves of 132 SMs; BN = 128 gives 3.88).
//  - "mma.sync" (bf16, Cin and Cout multiples of 8): 16-byte cp.async
//    gathers, four shared-memory stages in flight (one barrier per K step of
//    32), BN = 128 with 64x32 warp tiles when Cout > 64, else BN = 64 with
//    32x32 warp tiles; ldmatrix + mma.sync m16n8k16.
//  - "narrow" (bf16, Cin 1 to 16, Cout a multiple of 16 up to 256: the UNet
//    family's first conv, (Cin, Cout) = (3, 64), and the TransUnet decoder's
//    last, (16, 16)): bound by bytes, not operations. At (512, 3, 64), batch
//    8, it does 27 MACs per output value and writes 268 MB of its 281 MB
//    (bound 0.084 ms at 3.35 TB/s). So x is read once and y written once,
//    with enough stores in flight: 3.35 TB/s x about 1 us of latency is
//    3.35 MB in flight over 132 SMs, about 25 KB an SM. A persistent grid
//    walks tiles of a few image rows (two of 512 columns at Cin 3, two
//    blocks an SM; four of 256 at Cin 16, one); a tile's rows of x
//    (contiguous in NHWC: 3 KB a row at (512, 3)) arrive once, by 16-byte
//    cp.async, while the tile before is multiplied, and are expanded once
//    into a halo of (rows + 2) x (columns + 2) pixels with the channels
//    padded to 8 (16 bytes) or 16 (32 bytes) and zeros outside the image. A tap's A operand is then a shifted window of 16-byte rows that
//    ldmatrix reads directly: Cin <= 8 takes two taps a k16 step (5 steps),
//    Cin 16 one (9 steps). mma.sync m16n8k16 is enough (the products take
//    about 20 us of the 84 at the tensor rate); the weight's fragments stay
//    in registers. Each warp rounds its part of a 128-pixel chunk into
//    shared memory in the TMA store's swizzle and writes it with its own
//    TMA stores (no block barrier a chunk), three chunks in flight at Cout
//    64 (2 x 3 x 16 KB an SM), two at Cout 16 (with the next tile's 48 KB
//    of x in flight).
//  - "reg" (ragged channel counts, and f32): loads through registers, the
//    next K step fetched while the current one is multiplied, BN = 64; bf16
//    on mma.sync, f32 in full f32 on the CUDA cores, so that it can be held
//    against a reference with TF32 off.
// Odd H and W need nothing special on the two gathering routes: pixels are
// addressed one by one along M.
//
// What bounds it on an H100: at the deep levels (H <= 128, Cin >= 128) the
// tensor-core FLOPs, 2*9*Cin per output value against a few bytes moved. At
// the 512x512 level the bytes: the first conv (Cin = 3) does 27 MACs per
// output value and is bound by writing the 64-channel bf16 output (the
// narrow route answers it), and the Cin = 64 convs sit near the card's ridge point (about 290 FLOP per byte if
// x is read once). The wgmma route answers the FLOPs. Per tap, each x value
// is read from L2 nine times; the staged halo reads it about 2.1 times
// (264 pixels for 128) where it is staged. Even so the Cout = 64 shapes
// stay under half of the tensor peak (PERF.md); at BN = 64 each k16
// product reads 4 KB of shared memory for 64 K MACs.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <type_traits>

#include "hopper_mma.cuh"
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
// Mainloop 3: bf16 on wgmma, Cin a multiple of 64, Cout of 16; TMA in and out.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;                  // output pixels a tile: Ht x Wt of one image
constexpr int WG_BK = 64;                   // input channels a K step, of one tap
constexpr int WG_THREADS = 384;             // a producer and two consumer warpgroups
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // the image rows of a K step: 16 KB
constexpr int WG_B_BOX = WG_BK * 64 * 2;       // one 64 x 64 box of the weight: 8 KB
// The halo of a 2 x 64 pixel tile: 4 x 66 pixels of 64 channels (33 KB, a
// whole number of 1024-byte swizzle periods).
constexpr int HALO_COLS = 64 + 2;
constexpr int HALO_BYTES = 4 * HALO_COLS * WG_BK * 2;

// BN output channels a tile. A: per tap (HALO false) the tile's 128 pixel
// rows of one tap, a stage a K step; with HALO the 4 x 66 pixels around a
// 2 x 64 tile, a stage nine K steps (the nine taps of 64 input channels).
// B: the weight's 64 x BN block of a K step. As many stages as fit beside
// the epilogue's tile in the shared memory of BLOCKS blocks an SM.
template <int BN, bool HALO>
struct WgTile {
  // BN = 64 with the halo: two blocks an SM (80 registers, 2 + 3 stages), so
  // that one block's epilogue runs under the other's products
  static constexpr int BLOCKS = HALO && BN == 64 ? 2 : 1;
  static constexpr int A_BYTES = HALO ? HALO_BYTES : WG_A_BYTES;
  static constexpr int B_BYTES = BN / 64 * WG_B_BOX;
  static constexpr int A_STAGES = BLOCKS == 2 ? 2 : HALO ? 3 : BN == 256 ? 3 : BN == 128 ? 5 : 6;
  static constexpr int B_STAGES = BLOCKS == 2 ? 3 : HALO ? 5 : A_STAGES;
  static constexpr int EPI_BYTES = WG_BM * BN * 2;  // the bf16 output tile
  static constexpr int SMEM_BYTES = A_STAGES * A_BYTES + B_STAGES * B_BYTES + EPI_BYTES +
                                    2 * (A_STAGES + B_STAGES) * 8 /* barriers */ +
                                    1024 /* alignment */;
  static_assert(SMEM_BYTES * BLOCKS <= 233472 - 1024 * BLOCKS, "BLOCKS blocks an SM");
  static_assert(!HALO || BN <= 128, "the halo's stages leave no room for BN = 256");
};

struct WgParams {
  const float* scale;
  const float* bias;
  int Cin, Cout;
  int ht, wt;                             // the pixel tile, ht * wt = WG_BM
  int tiles_h, tiles_w, n_tiles, tiles;   // tiles = B * tiles_h * tiles_w * n_tiles
};

struct TileOrigin {
  int b, h0, w0, n0;
};

// Tile t, output channels innermost: the n_tiles tiles of one pixel tile are
// neighbours, so that blocks running at the same time read the same image
// rows from L2. kernels/fused_conv.py::conv_tile_origin is the same map.
__device__ __forceinline__ TileOrigin tile_origin(const WgParams& p, int t, int bn) {
  const int nt = t % p.n_tiles;
  int q = t / p.n_tiles;
  const int tw = q % p.tiles_w;
  q /= p.tiles_w;
  const int th = q % p.tiles_h;
  return {q / p.tiles_h, th * p.ht, tw * p.wt, nt * bn};
}

// A ring of stages on two mbarriers each: `full` (the TMA bytes have landed)
// and `empty` (the consumers' eight warps are done with it).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int n = 0;  // stages handed out so far
  __device__ __forceinline__ int stage() const { return n % stages; }
  __device__ __forceinline__ uint32_t parity() const { return (n / stages) & 1; }
};

// A persistent block walks tiles blockIdx.x, + gridDim.x, ..., each over K
// steps ks = 9 * (64-channel block) + tap. The producer warpgroup's first
// thread keeps the rings full with TMA: the A ring with 4-D boxes of x at
// (c0, w0 + dx - 1, h0 + dy - 1, b) a tap (with HALO one box at (c0, w0 - 1,
// h0 - 1, b) for all nine), whose parts outside the image (the padding, the
// ragged edge) arrive as zeros; the B ring with the weight's 64-column
// boxes. Each consumer warpgroup multiplies its 64 pixel rows (K-major; with
// HALO 64 consecutive rows of the halo, starting at row (cw + dy) * 66 + dx)
// by the B tile (MN-major, through the transpose bit) in one wgmma chain a K
// step, keeping one step in flight, then applies scale, bias and ReLU in f32,
// rounds once to bf16 into its half of the output tile and writes it with
// 4-D TMA stores, which clip pixels past H and W and channels past Cout.
template <int BN, bool HALO>
__global__ void __launch_bounds__(WG_THREADS, WgTile<BN, HALO>::BLOCKS)
    conv3x3_bn_relu_wgmma(const WgParams p, const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_y) {
  using TL = WgTile<BN, HALO>;
  constexpr int HALF_BYTES = TL::EPI_BYTES / 2;  // a consumer warpgroup's 64 rows
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* ring_a = align_1024(wsmem);
  unsigned char* ring_b = ring_a + TL::A_STAGES * TL::A_BYTES;
  unsigned char* epi = ring_b + TL::B_STAGES * TL::B_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + TL::EPI_BYTES);
  Ring a{bars, bars + TL::A_STAGES, TL::A_STAGES};
  Ring b{bars + 2 * TL::A_STAGES, bars + 2 * TL::A_STAGES + TL::B_STAGES, TL::B_STAGES};

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ksteps = 9 * (p.Cin / WG_BK);

  if (tid == 0) {
    for (int i = 0; i < TL::A_STAGES; ++i) {
      mbar_init(a.full + i, 1);
      mbar_init(a.empty + i, 8);
    }
    for (int i = 0; i < TL::B_STAGES; ++i) {
      mbar_init(b.full + i, 1);
      mbar_init(b.empty + i, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<TL::BLOCKS == 2 ? 24 : 40>();
    if (tid == 0) {
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const TileOrigin o = tile_origin(p, t, BN);
        // weight boxes wholly past Cout are not loaded: their columns of the
        // product are never stored
        const int boxes = min(BN, p.Cout - o.n0 + 63) / 64;
        for (int ks = 0; ks < ksteps; ++ks) {
          const int c0 = ks / 9 * WG_BK;
          const int tap = ks % 9;
          if (!HALO || tap == 0) {
            unsigned char* dst = ring_a + a.stage() * TL::A_BYTES;
            mbar_wait(a.empty + a.stage(), a.parity() ^ 1);
            mbar_expect_tx(a.full + a.stage(), TL::A_BYTES);
            if (HALO)
              tma_load_4d(dst, &map_x, a.full + a.stage(), c0, o.w0 - 1, o.h0 - 1, o.b);
            else
              tma_load_4d(dst, &map_x, a.full + a.stage(), c0, o.w0 + tap % 3 - 1,
                          o.h0 + tap / 3 - 1, o.b);
            ++a.n;
          }
          unsigned char* dst = ring_b + b.stage() * TL::B_BYTES;
          mbar_wait(b.empty + b.stage(), b.parity() ^ 1);
          mbar_expect_tx(b.full + b.stage(), boxes * WG_B_BOX);
          for (int j = 0; j < boxes; ++j)
            tma_load_3d(dst + j * WG_B_BOX, &map_w, b.full + b.stage(), o.n0 + 64 * j,
                        tap * p.Cin + c0, 0);
          ++b.n;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<TL::BLOCKS == 2 ? 104 : 232>();
  const int cw = wg - 1;           // rows 64 cw .. 64 cw + 63 of the pixel tile
  const int lane = tid % 32;
  const int r0 = (tid / 32) % 4 * 16 + lane / 4;  // accumulator rows r0, r0 + 8
  const int t4 = lane % 4;         // accumulator column pair
  unsigned char* out = epi + cw * HALF_BYTES;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileOrigin o = tile_origin(p, t, BN);
    const unsigned char* a_tile = ring_a;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int tap = ks % 9;
      const bool new_a = !HALO || tap == 0;
      if (new_a) {
        mbar_wait(a.full + a.stage(), a.parity());
        a_tile = ring_a + a.stage() * TL::A_BYTES;
        ++a.n;
      }
      const unsigned char* rows =
          HALO ? a_tile + ((cw + tap / 3) * HALO_COLS + tap % 3) * (WG_BK * 2)
               : a_tile + cw * tile_bytes<64, 64>();
      // a window may start off the 1024-byte swizzle period: the swizzle is
      // taken from the address bits, as the TMA wrote it, so the
      // descriptor's base offset stays 0
      const uint64_t da = desc_kmajor<64>(rows);
      const uint64_t db = desc_mnmajor_wide(ring_b + b.stage() * TL::B_BYTES);
      mbar_wait(b.full + b.stage(), b.parity());
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)  // the first product of a tile overwrites acc
        wgmma_kn(acc, da + kk * kmajor_step(), db + kk * mnmajor_step<64>(), ks | kk);
      wgmma_commit();
      ++b.n;
      // the previous step's products are done: free its B stage, and its A
      // stage if this step began another
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) {
        mbar_arrive(b.empty + (b.n - 2) % b.stages);
        if (new_a) mbar_arrive(a.empty + (a.n - 2) % a.stages);
      }
    }
    wgmma_wait<0>();
    keep_regs(acc);
    if (lane == 0) {
      mbar_arrive(b.empty + (b.n - 1) % b.stages);
      mbar_arrive(a.empty + (a.n - 1) % a.stages);
    }

    // epilogue: once this half's last stores have read it, the tile goes
    // through shared memory in the swizzled layout the TMA store reads
    if (tid % 128 == 0) bulk_wait_read();
    named_bar_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = o.n0 + 8 * j + 2 * t4;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (col < p.Cout) {  // Cout is even: both columns or neither
        s0 = __ldg(p.scale + col);
        s1 = __ldg(p.scale + col + 1);
        b0 = __ldg(p.bias + col);
        b1 = __ldg(p.bias + col + 1);
      }
      unsigned char* box = out + (j / 8) * tile_bytes<64, 64>();
      *reinterpret_cast<uint32_t*>(box + Swizzle<64>::offset(r0, j % 8) + 4 * t4) =
          pack_bf16x2(relu(acc[4 * j] * s0 + b0), relu(acc[4 * j + 1] * s1 + b1));
      *reinterpret_cast<uint32_t*>(box + Swizzle<64>::offset(r0 + 8, j % 8) + 4 * t4) =
          pack_bf16x2(relu(acc[4 * j + 2] * s0 + b0), relu(acc[4 * j + 3] * s1 + b1));
      // one 64-column box at a time: the scale and bias loads of the next
      // are not hoisted above this one, which would take registers from acc
      if (j % 8 == 7) asm volatile("" ::: "memory");
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (tid % 128 == 0) {
      const int rows_half = p.ht / 2;  // image rows of this half
      const int boxes = min(BN, p.Cout - o.n0 + 63) / 64;
      for (int j = 0; j < boxes; ++j)
        tma_store_4d(&map_y, out + j * tile_bytes<64, 64>(), o.n0 + 64 * j, o.w0,
                     o.h0 + cw * rows_half, o.b);
      bulk_commit();
    }
  }
  if (tid % 128 == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// Mainloop 4: bf16 with Cin <= 16 and Cout a multiple of 16 (at most 256),
// "narrow": a staged halo of image rows, mma.sync, TMA stores.
// ---------------------------------------------------------------------------

constexpr int NR_THREADS = 256;
constexpr int NR_CHUNK = 128;  // output pixels a chunk: of one image row
constexpr int NR_SMEM_MAX = 232448;

// CP: the channels a halo pixel holds in shared memory (Cin padded to 8 or
// 16: 16 or 32 bytes, so that a tap's A operand is a window of 16-byte rows
// that ldmatrix reads). NP: the output channels of a pass (64, 32 or 16,
// the widest that divides Cout), split between WN warps.
template <int CP, int NP>
struct NarrowCfg {
  static constexpr int TPS = 16 / CP;                 // taps a k16 step
  static constexpr int KSTEPS = (9 + TPS - 1) / TPS;  // 5 (CP 8) or 9 (CP 16)
  static constexpr int WN = NP == 16 ? 1 : 2;         // warps across a pass
  static constexpr int WM = NR_THREADS / 32 / WN;     // warps down a chunk
  static constexpr int FM = NR_CHUNK / WM / 16;       // m16 tiles a warp
  static constexpr int FN = NP / WN / 8;              // n8 tiles a warp
  static_assert(FN % 2 == 0, "B fragments are loaded in pairs");
  // blocks an SM the registers are capped for (128 a thread at 2), so that
  // one block's barriers, expansion and epilogue run under the other's
  // products (uncapped, the compiler takes more at (3, 64), and one block
  // an SM fits); CP 16 by NP 64 (72 registers of weight fragments) keeps one
  static constexpr int BLOCKS = CP == 16 && NP == 64 ? 1 : 2;
  // a warp's TMA store box of a pass: its 16 FM pixels by its 8 FN
  // channels, rows of 64 or 32 bytes in the swizzle of that width (16-byte
  // chunk bits [4, 6) or [4, 5) xor-ed with address bits [7, 9) or [7, 8))
  static constexpr int BOX_ROWS = 16 * FM;
  static constexpr int BOX_COLS = 8 * FN;
  static constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * 2;
  static constexpr int SWIZZLE = BOX_COLS * 2 == 64 ? 3 : 1;
  static_assert(BOX_COLS * 2 == 64 || BOX_COLS * 2 == 32, "a 64- or 32-byte swizzle");
};

struct NarrowParams {
  const bf16* x;
  const bf16* w;
  const float* scale;
  const float* bias;
  long long x_elems;
  int B, H, W, Cin, Cout;
  int tr, tw;          // a tile: tr image rows by tw columns (a multiple of NR_CHUNK)
  int tiles_h, tiles_w, tiles;
  int raw_row;         // elements of a staged row of x, a multiple of 8
  int stages;          // output chunks whose stores may be in flight, 1 to 3
};

// Bytes of each part of the block's shared memory, in this order: `stages`
// output chunks (each warp's boxes, one a pass), the weight (KSTEPS
// k16 steps of [k][Cout + 8]), scale and bias, 16 zero bytes, the halo of a
// tile ((tr + 2) x (tw + 2) pixels of CP channels) and its rows of x as they
// arrive.
struct NarrowSmem {
  int stage, weight, vectors, halo, raw, total;
};
inline __host__ __device__ NarrowSmem narrow_smem(int cp, int ksteps, const NarrowParams& p) {
  NarrowSmem s;
  s.stage = NR_CHUNK * p.Cout * 2;
  s.weight = ksteps * 16 * (p.Cout + 8) * 2;
  s.vectors = 2 * p.Cout * 4 + 16;
  s.halo = (p.tr + 2) * (p.tw + 2) * cp * 2;
  s.raw = (p.tr + 2) * p.raw_row * 2;
  s.total = 1024 /* alignment */ + p.stages * s.stage + s.weight + s.vectors + s.halo + s.raw;
  return s;
}

struct NarrowTile {
  int b, h0, w0;
};

__device__ __forceinline__ NarrowTile narrow_tile(const NarrowParams& p, int t) {
  const int tw = t % p.tiles_w;
  const int q = t / p.tiles_w;
  return {q / p.tiles_h, (q % p.tiles_h) * p.tr, tw * p.tw};
}

// Byte offset of the 16-byte half `half` of halo pixel P. With CP = 16 the
// halves of every other four pixels trade places, so that the eight rows an
// ldmatrix phase reads (eight neighbouring pixels, one half each) fall on
// distinct banks.
template <int CP>
__device__ __forceinline__ int narrow_halo_offset(int P, int half) {
  return CP == 8 ? P * 16 : P * 32 + ((half ^ ((P >> 2) & 1)) << 4);
}

// Queue the copies of a tile's rows of x: rows h0 - 1 .. h0 + tr of image b
// (those inside it), columns w0 - 1 .. w0 + tw clipped to the image, each
// as the 16-byte chunks of x that cover it. Row r lands at raw + r * raw_row,
// (its first element) % 8 elements in.
__device__ __forceinline__ void narrow_load(const NarrowParams& p, bf16* raw, NarrowTile o,
                                            int tid) {
  const int wa = max(o.w0 - 1, 0);
  const int wb = min(o.w0 + p.tw + 1, p.W);
  for (int r = 0; r < p.tr + 2; ++r) {
    const int h = o.h0 - 1 + r;
    if (h < 0 || h >= p.H) continue;
    const long long e0 = ((static_cast<long long>(o.b) * p.H + h) * p.W + wa) * p.Cin;
    const long long a0 = e0 & ~7LL;
    const int chunks = static_cast<int>((e0 - a0 + static_cast<long long>(wb - wa) * p.Cin + 7) >> 3);
    for (int q = tid; q < chunks; q += NR_THREADS) {
      const long long g = a0 + 8LL * q;
      const long long left = 2 * (p.x_elems - g);  // the last chunk of x may be short
      cp_async_16_bytes(raw + r * p.raw_row + 8 * q, p.x + g, left < 16 ? static_cast<int>(left) : 16);
    }
  }
}

// The tile's halo from its rows of x: channels padded to CP with zeros, and
// zeros outside the image (a halo is never read across two images).
template <int CP>
__device__ __forceinline__ void narrow_expand(const NarrowParams& p, const bf16* raw,
                                              unsigned char* halo, NarrowTile o, int tid) {
  const int cols = p.tw + 2;
  const int wa = max(o.w0 - 1, 0);
  if (p.Cin == CP) {  // Cin 8 or 16: each row starts on a 16-byte chunk
    constexpr int U = CP / 8;
    for (int u = tid; u < (p.tr + 2) * cols * U; u += NR_THREADS) {
      const int P = u / U, half = u % U;
      const int r = P / cols;
      const int h = o.h0 - 1 + r, w = o.w0 - 1 + (P - r * cols);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (h >= 0 && h < p.H && w >= 0 && w < p.W)
        v = *reinterpret_cast<const uint4*>(raw + r * p.raw_row + (w - wa) * CP + half * 8);
      *reinterpret_cast<uint4*>(halo + narrow_halo_offset<CP>(P, half)) = v;
    }
    return;
  }
  for (int P = tid; P < (p.tr + 2) * cols; P += NR_THREADS) {
    const int r = P / cols;
    const int h = o.h0 - 1 + r, w = o.w0 - 1 + (P - r * cols);
    uint32_t v[CP / 2];
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) v[i] = 0u;
    if (h >= 0 && h < p.H && w >= 0 && w < p.W) {
      // the row's first element, mod 8 (32-bit products keep the low bits)
      const unsigned shift =
          ((static_cast<unsigned>(o.b) * p.H + h) * static_cast<unsigned>(p.W) + wa) * p.Cin & 7u;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(raw + r * p.raw_row) +
                                  shift + (w - wa) * p.Cin;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        if (c < p.Cin) v[c / 2] |= static_cast<uint32_t>(src[c]) << (16 * (c % 2));
    }
#pragma unroll
    for (int half = 0; half < CP / 8; ++half)
      *reinterpret_cast<uint4*>(halo + narrow_halo_offset<CP>(P, half)) =
          make_uint4(v[4 * half], v[4 * half + 1], v[4 * half + 2], v[4 * half + 3]);
  }
}

template <int MASK>
__device__ __forceinline__ int narrow_swizzle(int offset) {
  return offset ^ (((offset >> 7) & MASK) << 4);
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...: tr image
// rows by tw columns of one image. The next tile's rows of x are in flight
// (cp.async) while this tile is multiplied; a tile's rows are expanded once
// into its halo, whose nine taps are shifted windows. Each 128-pixel chunk of
// a tile row is one implicit GEMM of 128 x Cout x (KSTEPS * 16), in passes of
// NP output channels: each warp multiplies its (16 FM) pixels by (8 FN)
// channels with ldmatrix + mma.sync m16n8k16, the weight's fragments held in
// registers, then applies scale, bias and ReLU in f32, rounds to bf16 into
// its box of the staged chunk in the store's swizzle, and its lane 0 writes
// the box with a TMA store (clipped past W), the warp's stores of `stages`
// chunks in flight.
template <int CP, int NP>
__global__ void __launch_bounds__(NR_THREADS, NarrowCfg<CP, NP>::BLOCKS)
    conv3x3_bn_relu_narrow(const NarrowParams p, const __grid_constant__ CUtensorMap map_y) {
  using C = NarrowCfg<CP, NP>;
  extern __shared__ __align__(1024) unsigned char nsmem[];
  const NarrowSmem L = narrow_smem(CP, C::KSTEPS, p);
  unsigned char* stages = align_1024(nsmem);
  bf16* ws = reinterpret_cast<bf16*>(stages + p.stages * L.stage);
  float* sc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ws) + L.weight);
  float* bi = sc + p.Cout;
  const bf16* zero = reinterpret_cast<const bf16*>(bi + p.Cout);
  unsigned char* halo = reinterpret_cast<unsigned char*>(bi + p.Cout) + 16;
  bf16* raw = reinterpret_cast<bf16*>(halo + L.halo);
  const int ldw = p.Cout + 8;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // the first tile's rows arrive while the weight is staged
  if (blockIdx.x < p.tiles) narrow_load(p, raw, narrow_tile(p, blockIdx.x), tid);
  cp_async_commit();
  // row k of the weight: tap k / CP, channel k % CP; zeros past the nine taps
  // and the Cin channels
  for (int i = tid; i < C::KSTEPS * 16 * p.Cout; i += NR_THREADS) {
    const int k = i / p.Cout, n = i - k * p.Cout;
    const int tap = k / CP, c = k % CP;
    ws[k * ldw + n] = tap < 9 && c < p.Cin ? p.w[(tap * p.Cin + c) * p.Cout + n]
                                           : __float2bfloat16(0.f);
  }
  for (int i = tid; i < p.Cout; i += NR_THREADS) {
    sc[i] = p.scale[i];
    bi[i] = p.bias[i];
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(bi + p.Cout)[tid] = 0u;

  const int wm = (warp % C::WM) * C::FM * 16;  // the warp's pixels of a chunk
  const int wn = (warp / C::WM) * C::FN * 8;   // its channels of a pass
  const int cols = p.tw + 2;
  // this lane's tap in each k16 step, as a pixel offset in the halo (CP 8:
  // taps 2 ks on lanes 0-15, 2 ks + 1 on lanes 16-31; -1 past the nine, which
  // reads the zero row), and (CP 16) its half of the channels
  int toff[C::KSTEPS];
#pragma unroll
  for (int ks = 0; ks < C::KSTEPS; ++ks) {
    const int tap = ks * C::TPS + (CP == 8 ? lane / 16 : 0);
    toff[ks] = tap < 9 ? tap / 3 * cols + tap % 3 : -1;
  }
  const int half = CP == 16 ? lane / 16 : 0;
  const int passes = p.Cout / NP;
  uint32_t breg[C::KSTEPS][C::FN][2];
  auto load_b = [&](int pass) {
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks)
#pragma unroll
      for (int j = 0; j < C::FN; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ldw + pass * NP +
                                 wn + j * 8 + (lane / 16) * 8);
        breg[ks][j][0] = r[0];
        breg[ks][j][1] = r[1];
        breg[ks][j + 1][0] = r[2];
        breg[ks][j + 1][1] = r[3];
      }
  };
  __syncthreads();
  if (passes == 1) load_b(0);

  int chunk = 0;  // chunks this block has stored
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const NarrowTile o = narrow_tile(p, t);
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows have landed; every warp is done with the last halo
    narrow_expand<CP>(p, raw, halo, o, tid);
    __syncthreads();  // the halo is whole, and the rows' buffer is free
    if (t + static_cast<int>(gridDim.x) < p.tiles)
      narrow_load(p, raw, narrow_tile(p, t + gridDim.x), tid);
    cp_async_commit();

    for (int r = 0; r < p.tr && o.h0 + r < p.H; ++r) {
      for (int cw = 0; cw < p.tw && o.w0 + cw < p.W; cw += NR_CHUNK, ++chunk) {
        // this warp's boxes of the chunk's stage, one a pass
        unsigned char* boxes = stages + (chunk % p.stages) * L.stage + warp * passes * C::BOX_BYTES;
        int base[C::FM];  // the halo pixel of this lane's A row at tap (0, 0)
#pragma unroll
        for (int i = 0; i < C::FM; ++i) base[i] = r * cols + cw + wm + i * 16 + lane % 16;
        for (int pass = 0; pass < passes; ++pass) {
          if (passes > 1) load_b(pass);
          float acc[C::FM][C::FN][4];
#pragma unroll
          for (int i = 0; i < C::FM; ++i)
#pragma unroll
            for (int j = 0; j < C::FN; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < C::KSTEPS; ++ks) {
            uint32_t a[C::FM][4];
#pragma unroll
            for (int i = 0; i < C::FM; ++i)
              ldmatrix_x4(a[i], toff[ks] < 0 ? zero
                                             : reinterpret_cast<const bf16*>(
                                                   halo + narrow_halo_offset<CP>(
                                                              base[i] + toff[ks], half)));
#pragma unroll
            for (int i = 0; i < C::FM; ++i)
#pragma unroll
              for (int j = 0; j < C::FN; ++j)
                mma_bf16_16816(acc[i][j], a[i], breg[ks][j][0], breg[ks][j][1]);
          }
          if (pass == 0) {
            // this warp's stores that last read these boxes have read them
            if (lane == 0) {
              if (p.stages == 3)
                bulk_wait_read<2>();
              else if (p.stages == 2)
                bulk_wait_read<1>();
              else
                bulk_wait_read<0>();
            }
            __syncwarp();
          }
          unsigned char* box = boxes + pass * C::BOX_BYTES;
#pragma unroll
          for (int i = 0; i < C::FM; ++i)
#pragma unroll
            for (int j = 0; j < C::FN; ++j) {
              const int row = i * 16 + lane / 4;
              const int col = j * 8 + (lane % 4) * 2;
              const int n = pass * NP + wn + col;
              const float s0 = sc[n], s1 = sc[n + 1], b0 = bi[n], b1 = bi[n + 1];
              *reinterpret_cast<uint32_t*>(
                  box + narrow_swizzle<C::SWIZZLE>(row * C::BOX_COLS * 2 + col * 2)) =
                  pack_bf16x2(relu(acc[i][j][0] * s0 + b0), relu(acc[i][j][1] * s1 + b1));
              *reinterpret_cast<uint32_t*>(
                  box + narrow_swizzle<C::SWIZZLE>((row + 8) * C::BOX_COLS * 2 + col * 2)) =
                  pack_bf16x2(relu(acc[i][j][2] * s0 + b0), relu(acc[i][j][3] * s1 + b1));
            }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          for (int pass = 0; pass < passes; ++pass)
            tma_store_4d(&map_y, boxes + pass * C::BOX_BYTES, pass * NP + wn, o.w0 + cw + wm,
                         o.h0 + r, o.b);
          bulk_commit();
        }
      }
    }
  }
  if (lane == 0) bulk_wait_all();
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

template <int BN, bool HALO>
cudaError_t launch_wgmma(const void* x, const void* w, const float* scale, const float* bias,
                         void* y, int B, int H, int W, int Cin, int Cout, int wt,
                         cudaStream_t stream) {
  constexpr int smem = WgTile<BN, HALO>::SMEM_BYTES;
  auto kernel = conv3x3_bn_relu_wgmma<BN, HALO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  WgParams p;
  p.scale = scale;
  p.bias = bias;
  p.Cin = Cin;
  p.Cout = Cout;
  p.wt = wt;
  p.ht = WG_BM / wt;
  p.tiles_h = (H + p.ht - 1) / p.ht;
  p.tiles_w = (W + wt - 1) / wt;
  p.n_tiles = (Cout + BN - 1) / BN;
  const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w * p.n_tiles;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  CUtensorMap map_x, map_w, map_y;
  // a box: the tile's pixels of one tap, or with HALO the 4 x 66 around it
  if ((err = make_bf16_map_4d(&map_x, x, {Cin, W, H, B},
                              {WG_BK, HALO ? HALO_COLS : wt, HALO ? 4 : p.ht, 1})) != cudaSuccess)
    return err;
  if ((err = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Cout, 64, 9LL * Cin, 1)) !=
      cudaSuccess)
    return err;
  if ((err = make_bf16_map_4d(&map_y, y, {Cout, W, H, B}, {64, wt, p.ht / 2, 1})) != cudaSuccess)
    return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int blocks = sms * WgTile<BN, HALO>::BLOCKS;
  kernel<<<p.tiles < blocks ? p.tiles : blocks, WG_THREADS, smem, stream>>>(p, map_x, map_w,
                                                                           map_y);
  return cudaGetLastError();
}

// The narrow route's tiles: at CP 8 two image rows of up to 512 columns and
// three chunks' stores in flight (two blocks an SM at the main path's
// (512, 3, 64)), at CP 16 four rows of up to 256 columns and two chunks in
// flight (one block an SM at (512, 16, 16)), where they fit; else the first
// plan whose shared memory fits one block. Of the plans timed on an H100
// at batch 8 (tr 2 to 8, tw 128 to 512, 2 to 4 chunks in flight), these
// were the fastest at those two shapes.
template <int CP, int NP>
cudaError_t launch_narrow(const void* x, const void* w, const float* scale, const float* bias,
                          void* y, int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using C = NarrowCfg<CP, NP>;
  auto kernel = conv3x3_bn_relu_narrow<CP, NP>;
  NarrowParams p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.scale = scale;
  p.bias = bias;
  p.x_elems = static_cast<long long>(B) * H * W * Cin;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  const int w_chunks = (W + NR_CHUNK - 1) / NR_CHUNK * NR_CHUNK;
  const int widest = CP == 8 ? 512 : 256;
  const int plans[][3] = {{CP == 8 ? 2 : 4, widest, CP == 8 ? 3 : 2},
                          {2, widest, 2},
                          {2, 128, 2},
                          {1, 128, 2},
                          {1, 128, 1}};
  int smem = 0;
  for (const auto& plan : plans) {
    p.tr = plan[0];
    p.tw = plan[1] < w_chunks ? plan[1] : w_chunks;
    p.stages = plan[2];
    // the chunks covering a row of tw + 2 pixels start up to 7 elements early
    p.raw_row = ((p.tw + 2) * Cin + 14 + 7) / 8 * 8;
    smem = narrow_smem(CP, C::KSTEPS, p).total;
    if (smem <= NR_SMEM_MAX) break;
  }
  if (smem > NR_SMEM_MAX) return cudaErrorInvalidValue;
  p.tiles_h = (H + p.tr - 1) / p.tr;
  p.tiles_w = (W + p.tw - 1) / p.tw;
  const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map_y;
  const CUtensorMapSwizzle swizzle =
      C::SWIZZLE == 3 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  if ((err = make_bf16_map_4d(&map_y, y, {Cout, W, H, B}, {C::BOX_COLS, C::BOX_ROWS, 1, 1},
                              swizzle)) != cudaSuccess)
    return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NR_THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * per_sm;
  kernel<<<p.tiles < blocks ? p.tiles : blocks, NR_THREADS, smem, stream>>>(p, map_y);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_narrow_np(const void* x, const void* w, const float* scale, const float* bias,
                             void* y, int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  if (Cout % 64 == 0)
    return launch_narrow<CP, 64>(x, w, scale, bias, y, B, H, W, Cin, Cout, stream);
  if (Cout % 32 == 0)
    return launch_narrow<CP, 32>(x, w, scale, bias, y, B, H, W, Cin, Cout, stream);
  return launch_narrow<CP, 16>(x, w, scale, bias, y, B, H, W, Cin, Cout, stream);
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
// contiguous; B*H*W < 2^31. The caller checks all of this. route names the
// mainloop: 0 the register one (any dtype and channel count), 1 the
// cp.async + mma.sync one (bf16, Cin and Cout multiples of 8), 2 the wgmma
// one (bf16, Cin a multiple of 64, Cout of 16) with the pixel tile wt wide
// (a power of two up to 64; 128 / wt rows), bn output channels a tile (64,
// 128 or 256) and, with halo = 1 (wt = 64, bn <= 128), the staged halo tile;
// 3 the narrow one (bf16, Cin 1 to 16, Cout a multiple of 16 up to 256),
// which plans its own tiles (wt, bn and halo unread);
// kernels/fused_conv.py::conv_route and conv_tile_plan derive them from the
// call alone. A route that cannot serve the call is refused with
// cudaErrorInvalidValue. Returns the launch's cudaError_t.
extern "C" int fused_conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                                     const void* bias, void* y, int B, int H, int W, int Cin,
                                     int Cout, int dtype, int route, int wt, int bn, int halo,
                                     void* stream) {
  const int M = B * H * W;
  const float* s = static_cast<const float*>(scale);
  const float* t = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 0 && dtype == 0) {
    err = launch_reg_any<float>(x, w, s, t, y, M, H, W, Cin, Cout, st);
  } else if (route == 0 && dtype == 1) {
    err = launch_reg_any<bf16>(x, w, s, t, y, M, H, W, Cin, Cout, st);
  } else if (route == 1 && dtype == 1 && Cin % 8 == 0 && Cout % 8 == 0) {
    err = Cout > 64 ? launch_pipe<128>(x, w, s, t, y, M, H, W, Cin, Cout, st)
                    : launch_pipe<64>(x, w, s, t, y, M, H, W, Cin, Cout, st);
  } else if (route == 2 && dtype == 1 && Cin % WG_BK == 0 && Cout % 16 == 0 && wt >= 1 &&
             wt <= 64 && (wt & (wt - 1)) == 0) {
    if (halo == 0 && bn == 64)
      err = launch_wgmma<64, false>(x, w, s, t, y, B, H, W, Cin, Cout, wt, st);
    else if (halo == 0 && bn == 128)
      err = launch_wgmma<128, false>(x, w, s, t, y, B, H, W, Cin, Cout, wt, st);
    else if (halo == 0 && bn == 256)
      err = launch_wgmma<256, false>(x, w, s, t, y, B, H, W, Cin, Cout, wt, st);
    else if (halo == 1 && wt == 64 && bn == 64)
      err = launch_wgmma<64, true>(x, w, s, t, y, B, H, W, Cin, Cout, wt, st);
    else if (halo == 1 && wt == 64 && bn == 128)
      err = launch_wgmma<128, true>(x, w, s, t, y, B, H, W, Cin, Cout, wt, st);
  } else if (route == 3 && dtype == 1 && Cin >= 1 && Cin <= 16 && Cout % 16 == 0 &&
             Cout <= 256) {
    err = Cin <= 8 ? launch_narrow_np<8>(x, w, s, t, y, B, H, W, Cin, Cout, st)
                   : launch_narrow_np<16>(x, w, s, t, y, B, H, W, Cin, Cout, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_conv3x3_bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
