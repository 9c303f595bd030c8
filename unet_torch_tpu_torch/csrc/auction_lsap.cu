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
// has real gathers and shared-memory atomics. So one block runs one instance
// to its own convergence; prices, owners, matches and the per-query winner
// keys live in shared memory (16 bytes a query, 16 a target), and only the
// rows of the targets that bid in a round are read, if at all.
//
// What bounds it on an H100: not bytes (the rows all rounds read, over the
// memory rate, are a few hundredths of a launch) but the chain of rounds.
// The instances of one CLTR step run up to 300-400 rounds, the tail with a
// single bidder a round, and a launch lasts as long as its slowest
// instance. So the design cuts what one round waits for, on one block of
// 512 threads an instance (measured faster than 1024 and 256):
//
//   * Rounds of one bidder (the tail) run on warp 0 alone, with no block
//     barrier, while the rest of the block waits at one. The bidder's (v1,
//     i1, v2) comes from the candidate cache where it can: for each target
//     and lane, the lane's part of the row's two best queries with their
//     benefits and the third-best value, as the warp's last full read of the
//     row left them. Prices only rise, so no other query of the part can
//     have passed that third value; while both candidates, at today's
//     prices, stand above it (the larger strictly), they are exactly the
//     part's top two, and 32 lanes give the row's exact (v1, i1, v2) from
//     shared memory. Otherwise the warp reads the row (16-byte loads) and
//     refills the entry. The lanes' parts merge in three warp reductions
//     (redux.sync) instead of five rounds of shuffles, and a lone bidder
//     wins without an atomic.
//   * Rounds of up to 16 bidders (one a warp) split each bidder's row over
//     16 / p2(n) warps (p2 the next power of two): one memory round trip;
//     each warp leaves its part's (v1, i1, v2) in shared memory, and after
//     one barrier warp 0 merges the parts, computes the bids and settles the
//     round: the winner per query by an atomicMax on a 64-bit key
//     (order-preserving bits of the bid, then the inverted target index: the
//     tie rule whatever order the lanes arrive in) read back after
//     __syncwarp, the prices, owners and matches, the reset of the keys.
//   * Wider rounds (the first ones) take one warp a row, an atomicMax a bid,
//     a barrier and an ordered compaction of the next list by ballot, popc
//     and a warp-count prefix.
//   * The next bidders are known in the winner phase: a loser bids again, a
//     displaced owner bids next. Their list is built in order by ballot and
//     popc, without atomics.
//
// Rows are read with 16-byte loads, or scalar ones when Q % 4 != 0 or the
// benefit is not 16-byte aligned. The cache takes 644 bytes a target and is
// left out where it does not fit (T above about 300 at Q = 2000); the
// one-bidder rounds then read every row.
//
// Every candidate is one rounded f32 subtract, max is exact and a bid is two
// rounded adds, so matches, round counts and bid counts equal the plain
// PyTorch version's (kernels/auction.py::auction_lsap_reference). Compiled
// without fast-math.
//
// The C entry point returns the launch's cudaError_t; the Python wrapper
// raises on nonzero.

#include <cstdint>

#include <math_constants.h>

namespace {

constexpr int THREADS = 512;  // a block's threads
constexpr int W = THREADS / 32;
constexpr float NEG = -1e30f;
constexpr int NO_Q = 0x7fffffff;  // no query
constexpr int MAX_SMEM = 232448;  // what a block may use on sm_90
// the block's scratch: the bidders' parts (or the compaction's warp counts),
// the next round's bidder count, rounds and bids
constexpr int MISC_BYTES = 256;
static_assert(3 * W * 4 + 3 * 4 <= MISC_BYTES, "the block's scratch");

// Bits of a float as an unsigned that orders as the float does.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Top2 {
  float v1;  // the largest value
  int i1;    // its first index
  float v2;  // the largest value at another index

  // the next candidate of a scan in increasing order of the query
  // (branch-free, as Top3::take)
  __device__ __forceinline__ void take(float val, float, int q) {
    const bool g = val > v1;
    v2 = fmaxf(v2, g ? v1 : val);
    i1 = g ? q : i1;
    v1 = g ? val : v1;
  }
};

// what a scan that saw no candidate holds
__device__ __forceinline__ Top2 none2() { return {-CUDART_INF_F, NO_Q, NEG}; }

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

__device__ __forceinline__ Top2 shfl_xor(const Top2& x, int off) {
  return {__shfl_xor_sync(0xffffffffu, x.v1, off), __shfl_xor_sync(0xffffffffu, x.i1, off),
          __shfl_xor_sync(0xffffffffu, x.v2, off)};
}

// the merge over aligned groups of `width` lanes (a power of two); every
// lane of a group ends with the group's result
__device__ __forceinline__ Top2 group_merge(Top2 x, int width) {
  for (int off = 1; off < width; off <<= 1) x = merge(x, shfl_xor(x, off));
  return x;
}

// The inverse of ordered_bits.
__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The merge over the whole warp, the lanes' parts of one row being
// disjoint, in three warp reductions: v1 the largest value, i1 the lowest
// index among the lanes that hold it, v2 the largest of everything else.
// Zeros are made +0 first, so that -0 and +0 tie as the float compares of
// `merge` have them (a bid is the same from either).
__device__ __forceinline__ Top2 warp_merge(const Top2& x) {
  const unsigned k1 = ordered_bits(x.v1 + 0.0f);
  const unsigned m1 = __reduce_max_sync(0xffffffffu, k1);
  const int i1 = static_cast<int>(
      __reduce_min_sync(0xffffffffu, k1 == m1 ? static_cast<unsigned>(x.i1) : 0xffffffffu));
  const float other = k1 == m1 && x.i1 == i1 ? x.v2 : fmaxf(x.v1, x.v2);
  const unsigned m2 = __reduce_max_sync(0xffffffffu, ordered_bits(other + 0.0f));
  return {from_ordered(m1), i1, from_ordered(m2)};
}

// A lane's part of a row as the candidate cache keeps it: the largest value
// with its benefit and first index (NO_Q while the part saw no query), the
// largest at another index with its benefit and index (NO_Q while it saw
// fewer than two), and the largest value at a third index (-inf while it
// saw fewer than three). Branch-free: the lanes of a warp do not diverge.
struct Top3 {
  float a, ba;
  int ia;
  float b, bb;
  int ib;
  float c;

  __device__ __forceinline__ void take(float val, float ben, int q) {
    const bool ga = val > a;
    const bool gb = val > b;
    c = gb ? b : fmaxf(c, val);
    bb = ga ? ba : (gb ? ben : bb);
    ib = ga ? ia : (gb ? q : ib);
    b = ga ? a : (gb ? val : b);
    ba = ga ? ben : ba;
    ia = ga ? q : ia;
    a = ga ? val : a;
  }
  // what Top2 would have taken from the same candidates (its second value
  // has a -1e30 floor)
  __device__ __forceinline__ Top2 top2() const { return {a, ia, fmaxf(b, NEG)}; }
};

__device__ __forceinline__ Top3 none3() {
  return {-CUDART_INF_F, 0.f, NO_Q, -CUDART_INF_F, 0.f, NO_Q, -CUDART_INF_F};
}

// One part of a bidder's row into `acc`: benefit - price over the 16-byte
// chunks (VEC) or values c = part * 32 + lane + k * 32 * parts, each thread
// in increasing order of the query.
template <bool VEC, typename Acc, typename Row>
__device__ __forceinline__ void scan_part(Acc& acc, Row row, const float* price, int Q, int part,
                                          int parts, int lane) {
  const int stride = 32 * parts;
  if constexpr (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(price);
#pragma unroll 8
    for (int c = part * 32 + lane; c < Q / 4; c += stride) {
      const float4 b = row(c);
      const float4 p = p4[c];
      acc.take(b.x - p.x, b.x, 4 * c);
      acc.take(b.y - p.y, b.y, 4 * c + 1);
      acc.take(b.z - p.z, b.z, 4 * c + 2);
      acc.take(b.w - p.w, b.w, 4 * c + 3);
    }
  } else {
#pragma unroll 8
    for (int q = part * 32 + lane; q < Q; q += stride) {
      const float b = row(q);
      acc.take(b - price[q], b, q);
    }
  }
}

struct Shared {
  unsigned long long* best;    // [Q] winner keys, 0 when none
  float* price;                // [Q]
  int* owner;                  // [Q] target or T
  int* match;                  // [T] query or -1
  int* ulist;                  // [T] this round's bidders
  int* bid_q;                  // [T] their queries (rounds of more than W bidders)
  float* bid_v;                // [T] their bids
  float* red_v1;               // [W] bidders' parts
  int* red_i1;                 // [W]
  float* red_v2;               // [W]
  int* cnt;                    // [2][W] compaction's warp counts, over red_v1 and red_i1
  int* state;                  // [3] the next round's bidder count, rounds, bids
  // the candidate cache, [T][32] (a target's row, one part a lane), when it fits
  int* c_ok;                   // [T] the target's entry is filled
  int* c_ia;
  int* c_ib;
  float* c_ba;
  float* c_bb;
  float* c_thr;
};

__device__ __forceinline__ Shared carve(unsigned char* smem, int T, int Q) {
  Shared s;
  s.best = reinterpret_cast<unsigned long long*>(smem);
  s.price = reinterpret_cast<float*>(s.best + Q);
  s.owner = reinterpret_cast<int*>(s.price + Q);
  s.match = s.owner + Q;
  s.ulist = s.match + T;
  s.bid_q = s.ulist + T;
  s.bid_v = reinterpret_cast<float*>(s.bid_q + T);
  s.red_v1 = s.bid_v + T;
  s.red_i1 = reinterpret_cast<int*>(s.red_v1 + W);
  s.red_v2 = reinterpret_cast<float*>(s.red_i1 + W);
  s.cnt = reinterpret_cast<int*>(s.red_v1);
  s.state = reinterpret_cast<int*>(s.red_v2 + W);
  s.c_ok = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(s.red_v1) + MISC_BYTES);
  s.c_ia = s.c_ok + T;
  s.c_ib = s.c_ia + T * 32;
  s.c_ba = reinterpret_cast<float*>(s.c_ib + T * 32);
  s.c_bb = s.c_ba + T * 32;
  s.c_thr = s.c_bb + T * 32;
  return s;
}

// The winner t takes query q at `bid` and its winner key is reset; the
// former owner, if any, becomes unassigned. Returns the former owner, or -1.
__device__ __forceinline__ int owner_swap(const Shared& s, int q, int t, float bid, int T) {
  const int prev = s.owner[q];
  if (prev < T) s.match[prev] = -1;
  s.price[q] = fmaxf(bid, s.price[q]);
  s.owner[q] = t;
  s.match[t] = q;
  s.best[q] = 0ull;
  return prev < T ? prev : -1;
}

// Ordered compaction of one chunk of THREADS candidates: the position of
// this thread's entry (>= 0) among the chunk's entries, and their number in
// `total`. cnt is the chunk's [W] of warp counts; one block barrier.
__device__ __forceinline__ int chunk_rank(bool has, int* cnt, int& total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const unsigned mask = __ballot_sync(0xffffffffu, has);
  if (lane == 0) cnt[warp] = __popc(mask);
  __syncthreads();
  int c = lane < W ? cnt[lane] : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, c, off);
    if (lane >= off) c += y;
  }
  const int before = __shfl_sync(0xffffffffu, c, warp > 0 ? warp - 1 : 0);
  total = __shfl_sync(0xffffffffu, c, 31);
  return (warp > 0 ? before : 0) + __popc(mask & ((1u << lane) - 1u));
}

// One part of target t's row into `acc`, from global memory.
template <bool VEC, typename Acc>
__device__ __forceinline__ void scan_row(Acc& acc, const Shared& s, const float* __restrict__ ben,
                                         int Q, int t, int part, int parts, int lane) {
  const float* row = ben + static_cast<long long>(t) * Q;
  if constexpr (VEC)
    scan_part<true>(acc, [row](int c) { return __ldg(reinterpret_cast<const float4*>(row) + c); },
                    s.price, Q, part, parts, lane);
  else
    scan_part<false>(acc, [row](int q) { return __ldg(row + q); }, s.price, Q, part, parts, lane);
}

// This lane's part of target t's row from the candidate cache, at today's
// prices: exact when its two candidates still stand above the third value
// they had (prices only rise, so no other query of the part can have
// passed it). Returns false when they do not, and the row must be read.
__device__ __forceinline__ bool cached_part(const Shared& s, int t, int lane, Top2& x) {
  const int k = t * 32 + lane;
  const int ia = s.c_ia[k];
  if (ia == NO_Q) {  // a part without queries
    x = none2();
    return true;
  }
  const int ib = s.c_ib[k];
  const float va = s.c_ba[k] - s.price[ia];
  const float vb = ib != NO_Q ? s.c_bb[k] - s.price[ib] : -CUDART_INF_F;
  const float c = s.c_thr[k];
  if (va > vb || (va == vb && ia < ib))
    x = {va, ia, fmaxf(vb, NEG)};
  else
    x = {vb, ib, fmaxf(va, NEG)};
  return fminf(va, vb) >= c && fmaxf(va, vb) > c;
}

__device__ __forceinline__ void cache_part(const Shared& s, int t, int lane, const Top3& y) {
  const int k = t * 32 + lane;
  s.c_ia[k] = y.ia;
  s.c_ba[k] = y.ba;
  s.c_ib[k] = y.ib;
  s.c_bb[k] = y.bb;
  s.c_thr[k] = y.c;
}

// Warp 0 settles a round of at most 32 bidders, lane b holding bidder b's
// target t and its (v1, i1, v2): the bids, the winner per query (an
// atomicMax on its key, read back after __syncwarp; a bidder `alone` in its
// round has no bid to beat), the prices, owners and matches. Returns this
// lane's entry of the next list: the displaced owner of a winner (or -1
// when the query had none), a loser itself, -1 for a lane without a bidder.
__device__ __forceinline__ int settle(const Shared& s, const Top2& x, int t, bool bidder, bool alone,
                                      float eps, int T) {
  float bid = NEG;
  unsigned long long key = 0ull;
  if (bidder) {
    bid = s.price[x.i1] + (x.v1 - x.v2) + eps;
    if (bid > NEG && !alone) {
      key = (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
            (0xffffffffu - static_cast<unsigned>(t));
      atomicMax(&s.best[x.i1], key);
    }
  }
  bool won = bidder && bid > NEG;
  if (!alone) {
    __syncwarp();
    won = won && s.best[x.i1] == key;
    __syncwarp();
  }
  if (won) return owner_swap(s, x.i1, t, bid, T);
  return bidder ? t : -1;
}

// Warp 0 writes the next list in order (entries >= 0 of its lanes); returns
// the list's length.
__device__ __forceinline__ int write_list(const Shared& s, int entry, int lane) {
  const unsigned mask = __ballot_sync(0xffffffffu, entry >= 0);
  const int r = __popc(mask & ((1u << lane) - 1u));
  if (entry >= 0) s.ulist[r] = entry;
  __syncwarp();
  return __popc(mask);
}

// Rounds of one bidder, by warp 0 alone while the rest of the block waits
// at a barrier: no block barrier a round. The bidder's (v1, i1, v2) comes
// from the candidate cache (`cache`: it fits) when every lane's part of it
// still holds; otherwise the warp reads the whole row and refills the
// bidder's cache entry. Then the round is settled and the next list kept in
// shared memory. Ends when the list grows past one bidder, empties or
// max_iters runs out.
template <bool VEC>
__device__ void solo_rounds(const Shared& s, const float* __restrict__ ben, float eps, int T,
                            int Q, bool cache, int max_iters, int& n, int& it, int& bids) {
  const int lane = threadIdx.x % 32;
  do {
    const int t = s.ulist[0];
    Top2 x;
    if (!(cache && s.c_ok[t] && __all_sync(0xffffffffu, cached_part(s, t, lane, x)))) {
      if (cache) {
        Top3 y = none3();
        scan_row<VEC>(y, s, ben, Q, t, 0, 1, lane);
        cache_part(s, t, lane, y);
        if (lane == 0) s.c_ok[t] = 1;
        x = y.top2();
      } else {
        x = none2();
        scan_row<VEC>(x, s, ben, Q, t, 0, 1, lane);
      }
    }
    x = warp_merge(x);
    const int entry = settle(s, x, t, lane == 0, true, eps, T);
    ++bids;
    ++it;
    n = write_list(s, entry, lane);
  } while (n == 1 && it < max_iters);
}

template <bool VEC>
__device__ void run_instance(const Shared& s, const float* __restrict__ ben,
                             const unsigned char* __restrict__ vld, float eps, int T, int Q,
                             bool cache, int max_iters, int& it, int& bids, int& n) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // the first round's bidders: every valid target, in order
  n = 0;
  for (int c = 0; c * THREADS < T; ++c) {
    const int t = c * THREADS + tid;
    const bool has = t < T && vld[t];
    int total;
    const int r = n + chunk_rank(has, s.cnt + (c & 1) * W, total);
    if (has) s.ulist[r] = t;
    n += total;
  }
  __syncthreads();

  it = 0;
  bids = 0;
  while (n > 0 && it < max_iters) {
    if (n == 1) {
      if (warp == 0) {
        solo_rounds<VEC>(s, ben, eps, T, Q, cache, max_iters, n, it, bids);
        if (lane == 0) {
          s.state[0] = n;
          s.state[1] = it;
          s.state[2] = bids;
        }
      }
      __syncthreads();
      n = s.state[0];
      it = s.state[1];
      bids = s.state[2];
      continue;
    }
    if (n <= W) {
      // bid: each bidder's row split over `parts` warps, one part a warp
      int p2 = 1;
      while (p2 < n) p2 <<= 1;
      const int parts = W / p2;
      for (int idx = warp; idx < n * parts; idx += W) {
        Top2 x = none2();
        scan_row<VEC>(x, s, ben, Q, s.ulist[idx / parts], idx % parts, parts, lane);
        x = warp_merge(x);
        if (lane == 0) {
          s.red_v1[idx] = x.v1;
          s.red_i1[idx] = x.i1;
          s.red_v2[idx] = x.v2;
        }
      }
      __syncthreads();

      // warp 0 settles the round: lane b takes bidder b
      if (warp == 0) {
        Top2 x = none2();
        if (lane < n * parts) x = {s.red_v1[lane], s.red_i1[lane], s.red_v2[lane]};
        x = group_merge(x, parts);
        const int src = lane < n ? lane * parts : 0;
        x = {__shfl_sync(0xffffffffu, x.v1, src), __shfl_sync(0xffffffffu, x.i1, src),
             __shfl_sync(0xffffffffu, x.v2, src)};
        const int entry = settle(s, x, lane < n ? s.ulist[lane] : -1, lane < n, false, eps, T);
        const int next = write_list(s, entry, lane);
        if (lane == 0) s.state[0] = next;
      }
      __syncthreads();
      bids += n;
      n = s.state[0];
    } else {
      // bid: one warp a row
      for (int j = warp; j < n; j += W) {
        Top2 x = none2();
        scan_row<VEC>(x, s, ben, Q, s.ulist[j], 0, 1, lane);
        x = warp_merge(x);
        if (lane == 0) {
          const int t = s.ulist[j];
          const float bid = s.price[x.i1] + (x.v1 - x.v2) + eps;
          s.bid_q[j] = x.i1;
          s.bid_v[j] = bid;
          if (bid > NEG)
            atomicMax(&s.best[x.i1], (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
                                         (0xffffffffu - static_cast<unsigned>(t)));
        }
      }
      __syncthreads();

      // winners take their queries; the next list is compacted in place
      // (an entry's position is at most its bidder's index)
      int next = 0;
      for (int c = 0; c * THREADS < n; ++c) {
        const int j = c * THREADS + tid;
        int entry = -1;
        if (j < n) {
          const int t = s.ulist[j];
          const int q = s.bid_q[j];
          const float bid = s.bid_v[j];
          const unsigned long long key =
              (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
              (0xffffffffu - static_cast<unsigned>(t));
          entry = bid > NEG && s.best[q] == key ? owner_swap(s, q, t, bid, T) : t;
        }
        int total;
        const int r = next + chunk_rank(entry >= 0, s.cnt + (c & 1) * W, total);
        if (entry >= 0) s.ulist[r] = entry;
        next += total;
      }
      __syncthreads();
      bids += n;
      n = next;
    }
    ++it;
  }
}

struct Params {
  const float* benefit;        // (B, T, Q)
  const unsigned char* valid;  // (B, T)
  const float* eps;            // (B,)
  int* match;                  // (B, T)
  int* rounds;                 // (B,)
  int* bids;                   // (B,)
  int T, Q, max_iters;
  int cache;  // the candidate cache fits
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS) auction_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, Q = p.Q;
  const Shared s = carve(smem, T, Q);
  const int z = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* ben = p.benefit + static_cast<long long>(z) * T * Q;
  const unsigned char* vld = p.valid + static_cast<long long>(z) * T;

  for (int q = tid; q < Q; q += THREADS) {
    s.best[q] = 0ull;
    s.price[q] = 0.0f;
    s.owner[q] = T;
  }
  for (int t = tid; t < T; t += THREADS) {
    s.match[t] = -1;
    if (p.cache) s.c_ok[t] = 0;
  }
  __syncthreads();

  int it, bids, n;
  run_instance<VEC>(s, ben, vld, p.eps[z], T, Q, p.cache != 0, p.max_iters, it, bids, n);

  // greedy completion: n leftovers only when max_iters ran out
  if (n > 0) {
    int* match = s.match;
    unsigned char* owned = reinterpret_cast<unsigned char*>(s.best);  // [Q] flags
    __syncthreads();
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
      int bi = NO_Q;
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
        s.red_v1[warp] = bv;
        s.red_i1[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < W; ++w) {
          if (s.red_v1[w] > bv || (s.red_v1[w] == bv && s.red_i1[w] < bi)) {
            bv = s.red_v1[w];
            bi = s.red_i1[w];
          }
        }
        owned[bi] = 1;
        match[t] = bi;
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < T; t += THREADS) {
    p.match[static_cast<long long>(z) * T + t] = vld[t] ? s.match[t] : 0;
  }
  if (tid == 0) {
    p.rounds[z] = it;
    p.bids[z] = bids;
  }
}

// 16 bytes a query and a target, the block's scratch and, with `cache`, the
// candidate cache (644 bytes a target)
size_t smem_bytes(int T, int Q, bool cache) {
  return static_cast<size_t>(Q) * 16 + static_cast<size_t>(T) * 16 + MISC_BYTES +
         (cache ? static_cast<size_t>(T) * (4 + 5 * 32 * 4) : 0);
}

template <bool VEC>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = auction_kernel<VEC>;
  const size_t bytes = smem_bytes(p.T, p.Q, p.cache);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<B, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// benefit (B, T, Q) f32, valid (B, T) u8, eps (B,) f32, all contiguous;
// match (B, T), rounds (B,) and bids (B,) i32. The one-bidder rounds keep
// the candidate cache where it fits a block's shared memory; 16-byte loads
// need Q % 4 == 0 and a 16-byte aligned benefit. Returns the launch's
// cudaError_t; cudaErrorInvalidValue when 16 Q + 16 T bytes and the block's
// scratch do not fit a block's shared memory.
extern "C" int auction_lsap(const void* benefit, const void* valid, const void* eps, void* match,
                            void* rounds, void* bids, int B, int T, int Q, int max_iters,
                            void* stream) {
  if (B < 1 || T < 1 || Q < 1 || max_iters < 0 || smem_bytes(T, Q, false) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.benefit = static_cast<const float*>(benefit);
  p.valid = static_cast<const unsigned char*>(valid);
  p.eps = static_cast<const float*>(eps);
  p.match = static_cast<int*>(match);
  p.rounds = static_cast<int*>(rounds);
  p.bids = static_cast<int*>(bids);
  p.T = T;
  p.Q = Q;
  p.max_iters = max_iters;
  p.cache = smem_bytes(T, Q, true) <= MAX_SMEM;
  const bool vec = Q % 4 == 0 && reinterpret_cast<uintptr_t>(benefit) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(p, B, st) : launch<false>(p, B, st));
}

extern "C" const char* auction_lsap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
