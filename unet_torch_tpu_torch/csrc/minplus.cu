// Batched min-plus (tropical) matrix product for Hopper (sm_90a):
//
//     C[z, i, j] = min_k ( A[z, i, k] + B[z, k, j] ),   f32,
//
// A (Bt, M, K), B (Bt, K, N), C (Bt, M, N), the last two dimensions of each
// contiguous. Either input may have a batch stride of 0: one matrix shared by
// the whole batch. Two launches make the exact squared Euclidean distance
// transform of a stack of masks (losses/functional.py
// euclidean_distance_transform_sq): the shared (H, H) table of (i - k)^2
// against each mask's column sources, then each result against the shared
// (W, W) table of (l - j)^2. The Hausdorff-DT loss runs all of a step's masks
// through those two launches.
//
// Replaces unet_torch_tpu/kernels/minplus.py::minplus_pallas, which tiles a
// single 2-D product 128^3 over a sequential grid, carries the running minimum
// in the output block from one k step to the next, and pads ragged shapes
// with finfo.max / 4. Here blocks run in parallel, so the k loop is inside the
// block, the batch is a grid dimension, and ragged edges are guarded in the
// kernel (a tile element outside the matrices is +inf, which no minimum
// picks), so nothing is padded or copied.
//
// What bounds it on an H100: operations. A product of (M, K) by (K, N) takes
// M*N*K adds and as many mins on the f32 CUDA cores (no tensor-core form of
// min-plus exists), against 4*(M*K + K*N + M*N) bytes: at 512^3 that is 2.7e8
// lane operations for 3 MiB, about 85 operations a byte, far above what the
// memory can feed. So the design keeps the f32 pipes busy: a 128 x 128 tile
// of C per block of 256 threads, each thread an 8 x 8 block of C in registers
// (as 2 x 2 groups of 4 x 4, so that a warp's shared-memory reads are
// contiguous float4s), K walked 16 at a time through shared memory, A stored
// k-major there so that both operands are read as float4. Each k step costs a
// thread four float4 loads for 128 operations. The next K slab is fetched into
// registers while the current one is used. Every candidate is one rounded f32
// add and min is exact, so the result equals the plain version bit for bit
// whatever the order of the k loop (compiled without fast-math; inputs hold
// no NaN).
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TM = 128;       // rows of C per block
constexpr int TN = 128;       // columns of C per block
constexpr int TK = 16;        // depth of one shared-memory slab
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads the banks
constexpr int A_PER_THREAD = TM * TK / THREADS;  // 8
constexpr int B_PER_THREAD = TK * TN / THREADS;  // 8

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
               int M, int K, int N, long long a_bs, long long b_bs) {
  __shared__ __align__(16) float As[TK][TM + PAD];  // As[k][m]
  __shared__ __align__(16) float Bs[TK][TN + PAD];  // Bs[k][n]

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  a += z * a_bs;
  b += z * b_bs;
  c += static_cast<long long>(z) * M * N;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group

  // global -> register staging. A: thread reads column k = tid % 16 of rows
  // tid / 16 + 16 i. B: thread reads column n = tid % 128 of rows
  // tid / 128 + 2 i (consecutive threads on consecutive addresses).
  const int a_k = tid % TK;
  const int a_m = tid / TK;
  const int b_n = tid % TN;
  const int b_k = tid / TN;
  float a_stage[A_PER_THREAD];
  float b_stage[B_PER_THREAD];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int m = m0 + a_m + (THREADS / TK) * i;
      const int k = k0 + a_k;
      a_stage[i] = (m < M && k < K) ? a[static_cast<long long>(m) * K + k] : CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int k = k0 + b_k + (THREADS / TN) * i;
      const int n = n0 + b_n;
      b_stage[i] = (k < K && n < N) ? b[static_cast<long long>(k) * N + n] : CUDART_INF_F;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) As[a_k][a_m + (THREADS / TK) * i] = a_stage[i];
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) Bs[b_k + (THREADS / TN) * i][b_n] = b_stage[i];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = CUDART_INF_F;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    stash();
    __syncthreads();
    if (k0 + TK < K) fetch(k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      // rows ty*4 .. +3 and 64 + ty*4 .. +3; columns likewise with tx
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < N) c[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// a: (Bt, M, K) f32 with batch stride a_bs elements (0: shared), rows
// contiguous; b: (Bt, K, N) likewise with b_bs; c: contiguous (Bt, M, N).
// Returns the launch's cudaError_t.
extern "C" int minplus(const void* a, const void* b, void* c, int Bt, int M, int K, int N,
                       long long a_bs, long long b_bs, void* stream) {
  if (Bt < 1 || M < 1 || K < 1 || N < 1 || Bt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, Bt);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, K, N,
      a_bs, b_bs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
