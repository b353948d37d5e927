// 64-bit selection keys and the warp-shuffle bitonic networks that sort
// them, shared by the cluster-KNN kernel (goldfinger_knn.cu) and the
// descent hops (hop_common.cuh).
//
// A key's high word is the sim's order-preserving bit pattern, its low
// word 0xFFFFFFFF - column, so a larger key is exactly (sim desc, column
// asc): the order of a stable descending sort, ties to the lowest
// column. Columns are unique, so the order is total, and a top-k by key
// does not depend on the order in which candidates arrive. Key 0 is
// "absent" and ranks below every present candidate.
#pragma once

#include "common.cuh"

namespace repro {

using Key = unsigned long long;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }
__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }

// The key of a sim at a column; -inf (an empty lane) is key 0. -0.0 is
// taken as +0.0 (they compare equal, so the column must decide); every
// other sim maps to a nonzero high word, 0x80000000 | bits for sim >= 0.
__device__ __forceinline__ Key sim_key(float sim, int col) {
  if (sim == neg_inf()) return 0;
  const uint32_t b = __float_as_uint(__fadd_rn(sim, 0.0f));
  const uint32_t hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<Key>(hi) << 32) |
         (0xffffffffu - static_cast<uint32_t>(col));
}

// The sim and the column of a nonzero key (inverse of sim_key).
__device__ __forceinline__ float key_sim(Key k) {
  const uint32_t hi = static_cast<uint32_t>(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

__device__ __forceinline__ int key_col(Key k) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(k));
}

// R bitonic sequences over the warp (element = lane) sorted descending;
// the R shuffle chains interleave.
template <int R>
__device__ __forceinline__ void bitonic_desc(Key (&x)[R], int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const bool hi = (lane & s) == 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const Key y = __shfl_xor_sync(kFullMask, x[i], s);
      x[i] = hi ? kmax(x[i], y) : kmin(x[i], y);
    }
  }
}

// R sets of 32 keys over the warp sorted ascending.
template <int R>
__device__ __forceinline__ void sort_asc(Key (&x)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      const bool lo = ((lane & s) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const Key y = __shfl_xor_sync(kFullMask, x[i], s);
        x[i] = lo ? kmin(x[i], y) : kmax(x[i], y);
      }
    }
  }
}

// One bitonic sequence of 32 P keys over the warp (element j * 32 + lane
// in x[j]) sorted descending: the compare-exchanges at distances of 32
// and more stay in each lane's registers, the rest are shuffles.
template <int P>
__device__ __forceinline__ void merge_desc(Key (&x)[P], int lane) {
#pragma unroll
  for (int d = P / 2; d > 0; d >>= 1) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if ((j & d) == 0) {
        const Key a = x[j], b = x[j + d];
        x[j] = kmax(a, b);
        x[j + d] = kmin(a, b);
      }
    }
  }
  bitonic_desc<P>(x, lane);
}

}  // namespace repro
