// Batched forward auction (Bertsekas, Jacobi bidding) for the linear sum
// assignment of DETR-style matching, for Hopper (sm_90a).
//
//   benefit (B, T, Q) f32: the benefit of giving target t the query q,
//   valid   (B, T)    u8 : 1 for a real target, 0 for a padded slot,
//   eps     (B,)      f32: the bidding increment of each instance,
//   ->  match  (B, T) i32: the query of each valid target (0 at padded slots),
//       rounds (B,)   i32: the bidding rounds the instance ran,
//       bids   (B,)   i32: the bids it made in all (benefit rows it read).
//
// One round: every unassigned valid target t looks at values = benefit[t] -
// price, takes the first argmax i1 (ties to the lowest query), the best
// value v1 and the best other value v2 (-1e30 when there is no other query),
// and bids price[i1] + (v1 - v2) + eps, in that order, in f32. Per query the
// highest bid wins, ties to the lowest target; the winner takes the query,
// price becomes max(bid, price), and the target that held the query becomes
// unassigned. Rounds repeat until no valid target is unassigned or max_iters
// is reached; then each leftover target, in order, takes its best-benefit
// query that nobody owns (greedy completion, normally nothing to do).
//
// Replaces unet_torch_tpu/kernels/auction.py::_auction_pallas (and the
// _greedy_complete pass after it). That kernel keeps an instance's whole
// (T, Q) tile in the TPU's VMEM and turns every gather and scatter into a
// one-hot pass over the tile, because its compiler has no scatter. A Hopper
// block has 227 KB of shared memory, less than one 32 x 2000 f32 tile, and it
// has real gathers and shared-memory atomics. So here one block of 1024
// threads runs one instance to its own convergence; prices, owners, matches
// and the per-query winner keys live in shared memory (16 bytes a query, 16 a
// target); only the rows of targets that bid in a round are read, one warp a
// row, from global memory (the instances' tiles stay in the 50 MB L2 while
// they fit); price[i1] is a gather; the per-query winner is one atomicMax on
// a 64-bit key (order-preserving bits of the bid, then the inverted target
// index), which is the same tie rule whatever order the warps arrive in.
// Ragged T and Q are guarded, nothing is padded.
//
// What bounds it on an H100: bytes. A bid costs one pass over Q floats with a
// subtract, two compares and a max per candidate, so the rows read in all
// rounds over the memory rate is the larger time by a factor of ten; but the
// loop is a chain of rounds with three block barriers each, and an instance
// cannot use more than one SM, so latency, not bandwidth, is what a launch
// waits for.
//
// Every candidate is one rounded f32 subtract, max is exact and a bid is two
// rounded adds, so matches and round counts equal the plain PyTorch version's
// (kernels/auction.py::auction_lsap_reference). Compiled without fast-math.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr int MAX_SMEM = 232448;  // what a block may use on sm_90

// Bits of a float as an unsigned that orders as the float does.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Top2 {
  float v1;  // the largest value
  int i1;    // its first index
  float v2;  // the largest value at another index
};

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  Top2 r;
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1)) {
    r.v1 = b.v1;
    r.i1 = b.i1;
    r.v2 = fmaxf(fmaxf(a.v1, a.v2), b.v2);
  } else {
    r.v1 = a.v1;
    r.i1 = a.i1;
    r.v2 = fmaxf(fmaxf(b.v1, b.v2), a.v2);
  }
  return r;
}

__device__ __forceinline__ Top2 warp_merge(Top2 x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 y;
    y.v1 = __shfl_xor_sync(0xffffffffu, x.v1, off);
    y.i1 = __shfl_xor_sync(0xffffffffu, x.i1, off);
    y.v2 = __shfl_xor_sync(0xffffffffu, x.v2, off);
    x = merge(x, y);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
auction_kernel(const float* __restrict__ benefit, const unsigned char* __restrict__ valid,
               const float* __restrict__ eps_all, int* __restrict__ match_out,
               int* __restrict__ rounds_out, int* __restrict__ bids_out, int T, int Q,
               int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* best = reinterpret_cast<unsigned long long*>(smem);  // [Q] winner keys
  float* price = reinterpret_cast<float*>(best + Q);                       // [Q]
  int* owner = reinterpret_cast<int*>(price + Q);                          // [Q] target or T
  int* match = owner + Q;                                                  // [T] query or -1
  int* ulist = match + T;                                                  // [T] bidders
  int* bid_q = ulist + T;                                                  // [T] their queries
  float* bid_v = reinterpret_cast<float*>(bid_q + T);                      // [T] their bids
  float* red_v = bid_v + T;                                                // [WARPS]
  int* red_i = reinterpret_cast<int*>(red_v + WARPS);                      // [WARPS]
  __shared__ int n_bidders;

  const int z = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* ben = benefit + static_cast<long long>(z) * T * Q;
  const unsigned char* vld = valid + static_cast<long long>(z) * T;
  const float eps = eps_all[z];

  for (int q = tid; q < Q; q += THREADS) {
    best[q] = 0ull;
    price[q] = 0.0f;
    owner[q] = T;
  }
  for (int t = tid; t < T; t += THREADS) match[t] = -1;

  int it = 0;
  int bids = 0;
  int n = 0;
  while (true) {
    if (tid == 0) n_bidders = 0;
    __syncthreads();
    for (int t = tid; t < T; t += THREADS) {
      if (vld[t] && match[t] < 0) ulist[atomicAdd(&n_bidders, 1)] = t;
    }
    __syncthreads();
    n = n_bidders;
    if (n == 0 || it >= max_iters) break;

    // bids: one warp a row
    for (int j = warp; j < n; j += WARPS) {
      const float* row = ben + static_cast<long long>(ulist[j]) * Q;
      Top2 x{-CUDART_INF_F, 0x7fffffff, NEG};
#pragma unroll 4
      for (int q = lane; q < Q; q += 32) {
        const float val = row[q] - price[q];
        if (val > x.v1) {
          x.v2 = fmaxf(x.v2, x.v1);
          x.v1 = val;
          x.i1 = q;
        } else {
          x.v2 = fmaxf(x.v2, val);
        }
      }
      x = warp_merge(x);
      if (lane == 0) {
        const float bid = price[x.i1] + (x.v1 - x.v2) + eps;
        bid_q[j] = x.i1;
        bid_v[j] = bid;
        if (bid > NEG) {
          const unsigned long long key =
              (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
              (0xffffffffu - static_cast<unsigned>(ulist[j]));
          atomicMax(&best[x.i1], key);
        }
      }
    }
    __syncthreads();

    // winners take their queries; the former owner becomes unassigned
    for (int j = tid; j < n; j += THREADS) {
      const int t = ulist[j];
      const int q = bid_q[j];
      const float bid = bid_v[j];
      if (bid > NEG && 0xffffffffu - static_cast<unsigned>(best[q]) == static_cast<unsigned>(t)) {
        const int prev = owner[q];
        if (prev < T) match[prev] = -1;
        price[q] = fmaxf(bid, price[q]);
        owner[q] = t;
        match[t] = q;
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) best[bid_q[j]] = 0ull;
    bids += n;
    ++it;
  }

  // greedy completion: n leftovers only when max_iters ran out
  if (n > 0) {
    unsigned char* owned = reinterpret_cast<unsigned char*>(best);  // [Q] flags
    for (int q = tid; q < Q; q += THREADS) owned[q] = 0;
    __syncthreads();
    for (int t = tid; t < T; t += THREADS) {
      if (match[t] >= 0) owned[match[t]] = 1;
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      if (!(vld[t] && match[t] < 0)) continue;  // uniform: shared data, read after a barrier
      const float* row = ben + static_cast<long long>(t) * Q;
      float bv = -CUDART_INF_F;
      int bi = 0x7fffffff;
      for (int q = tid; q < Q; q += THREADS) {
        const float val = owned[q] ? NEG : row[q];
        if (val > bv) {
          bv = val;
          bi = q;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < WARPS; ++w) {
          if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
            bv = red_v[w];
            bi = red_i[w];
          }
        }
        owned[bi] = 1;
        match[t] = bi;
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < T; t += THREADS) {
    match_out[static_cast<long long>(z) * T + t] = vld[t] ? match[t] : 0;
  }
  if (tid == 0) {
    rounds_out[z] = it;
    bids_out[z] = bids;
  }
}

size_t smem_bytes(int T, int Q) {
  return static_cast<size_t>(Q) * 16 + static_cast<size_t>(T) * 16 + WARPS * 8;
}

}  // namespace

// benefit (B, T, Q) f32, valid (B, T) u8, eps (B,) f32, all contiguous;
// match (B, T), rounds (B,) and bids (B,) i32. Returns the launch's
// cudaError_t; cudaErrorInvalidValue when 16 Q + 16 T bytes do not fit a
// block's shared memory.
extern "C" int auction_lsap(const void* benefit, const void* valid, const void* eps, void* match,
                            void* rounds, void* bids, int B, int T, int Q, int max_iters,
                            void* stream) {
  if (B < 1 || T < 1 || Q < 1 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(T, Q);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(eps), static_cast<int*>(match), static_cast<int*>(rounds),
      static_cast<int*>(bids), T, Q, max_iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* auction_lsap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
