// Fused multi-seed FastRandomHash of users' profiles.
//
// Replaces the TPU kernel src/repro/kernels/frh_minhash/frh_minhash.py
// ::minhash_pallas (body _minhash_kernel), reached through
// kernels/frh_minhash/ops.dataset_minhash, and the reference's host table
// of build Step 1 (core/hashing.user_distinct_hashes_np over item_hashes),
// which has no TPU kernel: the reference computes it in numpy.
//
//   h_s(item) = fmix32(item ^ (seed_s + 1) * 0x9E3779B9) & (b - 1)
//   H_s(u)    = min over the items of u of h_s(item)
//
// NO_HASH (2^31 - 1) for an empty profile; b is a power of two, so the
// modulo is a mask. All arithmetic is uint32 and wraps, as the reference's.
// Three entries share the device code:
//   - repro_frh_minhash_csr: H_s(u) of profiles as CSR (offsets int64[n + 1],
//     items int32[nnz]), what dataset_minhash passes: every item is read
//     once, and nothing else;
//   - repro_frh_minhash: H_s(u) of profiles padded to P items with PAD
//     (-1), the TPU kernel's own signature; PAD may sit anywhere in a row,
//     so the whole [n, P] matrix is read and PAD items are skipped;
//   - repro_frh_distinct_csr: for every (seed s, user u) of CSR profiles,
//     the `depth` smallest *distinct* values of h_s over u's items,
//     ascending and padded with NO_HASH, written as [t, n, depth]: the
//     table whose rows build Step 1's recursive split reads
//     (core/clustering.build_plan on a card).
//
// Design. One warp per user: its lanes read the row's items as 16-byte
// vectors (two per lane in flight), vector v covering items 4v .. 4v + 3
// of the array, so a row that does not start on a multiple of 4 still
// reads whole aligned vectors and masks the items outside it (at ml1M@1.0
// only 24.7% of the row offsets are multiples of 4); a vector past the
// array's end (or every vector, where the items are not 16-byte aligned)
// is read item by item. Items outside the row (and PAD) are masked into
// their hashes rather than branched around. Each lane keeps a running
// minimum for every one of the t seeds in registers (T, t rounded up to a
// power of 2, is the kernel's compile-time bound), so each item is read
// once for all seeds; the warp's minima are reduced by halving steps that
// leave one seed on each group of 32 / T lanes (9 shuffles at T = 8). The
// seeds' mixes go to the kernel by value (a struct of 32 words in its
// parameters), so no call copies them to the card.
//
// The distinct entry walks the rows the same way. In place of a running
// minimum, each lane keeps for each seed of its group a sorted list of the
// D smallest distinct hashes of its own items (D, depth rounded up to 1, 2,
// 4, 6 or 8, a compile-time bound; 8 seeds x 6 = 48 registers at the
// paper's t and depth), into which an item's hash is inserted by compares
// and selects at fixed register indices. A value among the row's `depth`
// smallest distinct ones is among the D smallest distinct ones of the lane
// that holds it, so `depth` rounds of a warp minimum over the lanes' list
// heads, each lane that holds the minimum popping it, give the row's
// values in order; lane d keeps round d's and the lanes write each seed's
// `depth` values as one contiguous store. No atomics, and nothing shared
// across warps. A block takes at most 8 seeds (the grid's y axis walks
// groups of 8 where t > 8), so a list of 8 x 8 fits the registers; at t <= 8
// each item is read from device memory once for all seeds.
//
// What bounds it: for the CSR entries the items, 4 bytes each (and for the
// distinct entry its output, 4 x depth bytes a (user, seed)), against ~11
// integer operations per (item, seed) for the hash, and ~3 x D more for
// the distinct entry's insert, on the CUDA cores. At ml1M@1.0 and t = 8
// the min-hash's two are about equal (0.0009 ms each), under the cost of
// one small launch. Rows are ragged (a mean of 113 items, a longest of
// 981), so a warp per user is balanced enough at that size: a longest row
// takes four rounds of loads where a mean one takes one.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per user row
constexpr int kMaxSeeds = 32;         // one seed per lane at the write
constexpr int kMaxDepth = 8;          // the distinct entry's list bound
constexpr int kGroup = 8;             // seeds of a distinct entry's block
constexpr uint32_t kNoHash = 0x7fffffffu;

struct Mixes {
  uint32_t m[kMaxSeeds];  // (seed + 1) * 0x9E3779B9 per seed
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// h(item) under a seed's mix, in [0, mask].
__device__ __forceinline__ uint32_t frh(int item, uint32_t mix,
                                        uint32_t mask) {
  return fmix32(static_cast<uint32_t>(item) ^ mix) & mask;
}

// Vector v of the items (items 4v .. 4v + 3): one 16-byte load where the
// items are 16-byte aligned (vec16) and the vector lies inside the array
// (nnz items), else item by item.
__device__ __forceinline__ int4 load_vec(const int* __restrict__ items,
                                         long long v, long long nnz,
                                         int vec16) {
  const long long i = 4 * v;
  if (vec16 && i + 3 < nnz)
    return __ldg(reinterpret_cast<const int4*>(items) + v);
  return make_int4(i < nnz ? __ldg(items + i) : 0,
                   i + 1 < nnz ? __ldg(items + i + 1) : 0,
                   i + 2 < nnz ? __ldg(items + i + 2) : 0,
                   i + 3 < nnz ? __ldg(items + i + 3) : 0);
}

// ~0 for an item at offset o of a row of len items that is outside it or
// PAD (kPad), else 0: OR-ed into its hash, it loses every min.
template <bool kPad>
__device__ __forceinline__ uint32_t dead(int o, int len, int item) {
  return static_cast<unsigned>(o) >= static_cast<unsigned>(len) ||
                 (kPad && item == repro::kPadId)
             ? ~0u
             : 0u;
}

// The minimum over the warp of each of the T seeds' x, written by the
// lanes that end up holding one: halving steps at offsets 16, 8, ... (each
// lane keeps the upper half of its seeds where its lane bit is set, and
// takes its partner's values for them), then plain steps over the rest;
// 9 shuffles for T = 8, not 40.
template <int T>
__device__ __forceinline__ void warp_min_write(uint32_t (&x)[T], int t,
                                               int lane, int* out) {
  int seed = 0;
  int off = 16;
#pragma unroll
  for (int h = T / 2; h >= 1; h >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const uint32_t send = up ? x[i] : x[i + h];
      const uint32_t keep = up ? x[i + h] : x[i];
      x[i] = min(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
    if (up) seed += h;
  }
#pragma unroll
  for (; off > 0; off >>= 1)
    x[0] = min(x[0], __shfl_xor_sync(0xffffffffu, x[0], off));
  if ((lane & (32 / T - 1)) == 0 && seed < t) out[seed] = static_cast<int>(x[0]);
}

// Walks items [s, e) of `items` (nnz of them in all) with the warp,
// calling take(x, o) on each lane's vector x, whose first item sits at
// offset o of the row (o < 0 or o >= e - s: outside it). vec16: the items
// are 16-byte aligned. A lane takes vectors v0 + lane and v0 + lane + 32
// of each 64 (both loads in flight, and the next 64's issued before these
// are taken); every lane calls take the same number of times, so take may
// use the warp's votes and shuffles.
template <typename Take>
__device__ __forceinline__ void walk_row(const int* __restrict__ items,
                                         long long s, long long e,
                                         long long nnz, int vec16, int lane,
                                         Take&& take) {
  const long long v0 = s >> 2, v1 = (e + 3) >> 2;
  const int4 none = make_int4(0, 0, 0, 0);
  // The next 64 vectors' loads are issued before this 64's hashing.
  int4 a = v0 + lane < v1 ? load_vec(items, v0 + lane, nnz, vec16) : none;
  int4 b = v0 + lane + 32 < v1 ? load_vec(items, v0 + lane + 32, nnz, vec16)
                               : none;
  for (long long base = v0; base < v1; base += 64) {
    const long long va = base + lane, vb = va + 32;
    int4 na = none, nb = none;
    if (base + 64 < v1) {
      na = va + 64 < v1 ? load_vec(items, va + 64, nnz, vec16) : none;
      nb = vb + 64 < v1 ? load_vec(items, vb + 64, nnz, vec16) : none;
    }
    take(a, static_cast<int>(4 * va - s));
    if (base + 32 < v1) take(b, static_cast<int>(4 * vb - s));
    a = na;
    b = nb;
  }
}

// Items [s, e) of `items` hashed under every seed by the warp: lane s
// writes seed s's minimum to out[0 .. t). kPad skips PAD items. Each lane
// hashes its vectors' 4 items under each seed and ORs each item's dead
// mask into its hash, so that no branch splits the warp; a vector no lane
// needs is skipped by all.
template <int T, bool kPad>
__device__ __forceinline__ void row_minhash(const int* __restrict__ items,
                                            long long s, long long e,
                                            long long nnz, const Mixes& mix,
                                            int t, uint32_t mask, int vec16,
                                            int lane, int* __restrict__ out) {
  uint32_t best[T];
#pragma unroll
  for (int j = 0; j < T; ++j) best[j] = kNoHash;
  const int len = static_cast<int>(e - s);
  walk_row(items, s, e, nnz, vec16, lane, [&](int4 x, int o) {
    const uint32_t d0 = dead<kPad>(o, len, x.x);
    const uint32_t d1 = dead<kPad>(o + 1, len, x.y);
    const uint32_t d2 = dead<kPad>(o + 2, len, x.z);
    const uint32_t d3 = dead<kPad>(o + 3, len, x.w);
    if (!__any_sync(0xffffffffu, (d0 & d1 & d2 & d3) == 0)) return;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j < t) {
        const uint32_t m = mix.m[j];
        const uint32_t h01 =
            min((fmix32(static_cast<uint32_t>(x.x) ^ m) & mask) | d0,
                (fmix32(static_cast<uint32_t>(x.y) ^ m) & mask) | d1);
        const uint32_t h23 =
            min((fmix32(static_cast<uint32_t>(x.z) ^ m) & mask) | d2,
                (fmix32(static_cast<uint32_t>(x.w) ^ m) & mask) | d3);
        best[j] = min(best[j], min(h01, h23));
      }
    }
  });
  warp_min_write<T>(best, t, lane, out);
}

// h into the ascending list l of distinct values (NO_HASH padded) when it
// is smaller than l's last and not in it; else l stays. A dead item's hash
// (~0) and a hash equal to NO_HASH never enter.
template <int D>
__device__ __forceinline__ void insert_distinct(uint32_t (&l)[D],
                                                uint32_t h) {
  bool fresh = h < l[D - 1];
#pragma unroll
  for (int i = 0; i < D - 1; ++i) fresh &= h != l[i];
  if (fresh) {
#pragma unroll
    for (int i = D - 1; i > 0; --i)
      l[i] = h < l[i - 1] ? l[i - 1] : (h < l[i] ? h : l[i]);
    l[0] = min(l[0], h);
  }
}

// Seed group g's G mixes, mix.m[g * G .. g * G + G), read at fixed
// indices so that the parameters are not copied to local memory.
template <int G>
__device__ __forceinline__ void group_mixes(const Mixes& mix, int g,
                                            uint32_t (&m)[G]) {
#pragma unroll
  for (int q = 0; q < kMaxSeeds / G; ++q) {
    if (q == g) {
#pragma unroll
      for (int j = 0; j < G; ++j) m[j] = mix.m[q * G + j];
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
frh_minhash_csr_kernel(const long long* __restrict__ offsets,
                       const int* __restrict__ items, long long nnz,
                       const Mixes mix, int* __restrict__ out, int n, int t,
                       uint32_t mask, int vec16) {
  const long long row = static_cast<long long>(blockIdx.x) * kRows +
                        (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  row_minhash<T, false>(items, __ldg(offsets + row), __ldg(offsets + row + 1),
                        nnz, mix, t, mask, vec16, threadIdx.x & 31,
                        out + row * t);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
frh_minhash_kernel(const int* __restrict__ items, const Mixes mix,
                   int* __restrict__ out, int n, int P, int t, uint32_t mask,
                   int vec16) {
  const long long row = static_cast<long long>(blockIdx.x) * kRows +
                        (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  row_minhash<T, true>(items, row * P, row * P + P,
                       static_cast<long long>(n) * P, mix, t, mask, vec16,
                       threadIdx.x & 31, out + row * t);
}

// Row `row`'s `depth` smallest distinct hashes under seeds g0 .. g0 + G of
// group blockIdx.y (those below t), to out[s][row][0 .. depth) of the
// [t, n, depth] table. D >= depth bounds each lane's lists.
template <int G, int D>
__global__ void __launch_bounds__(kThreads)
frh_distinct_csr_kernel(const long long* __restrict__ offsets,
                        const int* __restrict__ items, long long nnz,
                        const Mixes mix, int* __restrict__ out, int n, int t,
                        int depth, uint32_t mask, int vec16) {
  const long long row = static_cast<long long>(blockIdx.x) * kRows +
                        (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int g0 = static_cast<int>(blockIdx.y) * G;
  const int tg = min(G, t - g0);  // this group's seeds
  uint32_t m[G];
  group_mixes<G>(mix, blockIdx.y, m);
  uint32_t l[G][D];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < D; ++i) l[j][i] = kNoHash;
  const long long s = __ldg(offsets + row), e = __ldg(offsets + row + 1);
  const int len = static_cast<int>(e - s);
  walk_row(items, s, e, nnz, vec16, lane, [&](int4 x, int o) {
    const uint32_t d0 = dead<false>(o, len, x.x);
    const uint32_t d1 = dead<false>(o + 1, len, x.y);
    const uint32_t d2 = dead<false>(o + 2, len, x.z);
    const uint32_t d3 = dead<false>(o + 3, len, x.w);
    if (!__any_sync(0xffffffffu, (d0 & d1 & d2 & d3) == 0)) return;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < tg) {
        insert_distinct<D>(l[j], frh(x.x, m[j], mask) | d0);
        insert_distinct<D>(l[j], frh(x.y, m[j], mask) | d1);
        insert_distinct<D>(l[j], frh(x.z, m[j], mask) | d2);
        insert_distinct<D>(l[j], frh(x.w, m[j], mask) | d3);
      }
    }
  });
  // Round d: the warp's smallest list head is the row's d-th distinct
  // value; every lane whose head it is pops it. Lane d keeps round d's.
  uint32_t res[G];
#pragma unroll
  for (int j = 0; j < G; ++j) res[j] = kNoHash;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d < depth) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        uint32_t v = l[j][0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == d) res[j] = v;
        if (l[j][0] == v) {
#pragma unroll
          for (int i = 0; i < D - 1; ++i) l[j][i] = l[j][i + 1];
          l[j][D - 1] = kNoHash;
        }
      }
    }
  }
  if (lane < depth) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < tg)
        out[(static_cast<long long>(g0 + j) * n + row) * depth + lane] =
            static_cast<int>(res[j]);
  }
}

Mixes mixes_of(const int* seeds, int t) {
  Mixes mix = {};
  for (int j = 0; j < t; ++j)
    mix.m[j] = (static_cast<uint32_t>(seeds[j]) + 1u) * 0x9e3779b9u;
  return mix;
}

// The kernel instances for t seeds: T = t rounded up to a power of 2.
using CsrFn = void (*)(const long long*, const int*, long long, Mixes, int*,
                       int, int, uint32_t, int);
using PaddedFn = void (*)(const int*, Mixes, int*, int, int, int, uint32_t,
                          int);

CsrFn csr_kernel_for(int t) {
  if (t <= 1) return frh_minhash_csr_kernel<1>;
  if (t <= 2) return frh_minhash_csr_kernel<2>;
  if (t <= 4) return frh_minhash_csr_kernel<4>;
  if (t <= 8) return frh_minhash_csr_kernel<8>;
  if (t <= 16) return frh_minhash_csr_kernel<16>;
  return frh_minhash_csr_kernel<32>;
}

PaddedFn padded_kernel_for(int t) {
  if (t <= 1) return frh_minhash_kernel<1>;
  if (t <= 2) return frh_minhash_kernel<2>;
  if (t <= 4) return frh_minhash_kernel<4>;
  if (t <= 8) return frh_minhash_kernel<8>;
  if (t <= 16) return frh_minhash_kernel<16>;
  return frh_minhash_kernel<32>;
}

using DistinctFn = void (*)(const long long*, const int*, long long, Mixes,
                           int*, int, int, int, uint32_t, int);

// Seeds a block of the distinct entry takes: t rounded up to a power of
// 2, at most kGroup.
int distinct_group(int t) {
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : kGroup;
}

// The distinct entry's instance: G = distinct_group(t), D = depth rounded
// up to 1, 2, 4, 6 or 8.
template <int G>
DistinctFn distinct_for_depth(int depth) {
  if (depth <= 1) return frh_distinct_csr_kernel<G, 1>;
  if (depth <= 2) return frh_distinct_csr_kernel<G, 2>;
  if (depth <= 4) return frh_distinct_csr_kernel<G, 4>;
  if (depth <= 6) return frh_distinct_csr_kernel<G, 6>;
  return frh_distinct_csr_kernel<G, 8>;
}

DistinctFn distinct_kernel_for(int t, int depth) {
  switch (distinct_group(t)) {
    case 1: return distinct_for_depth<1>(depth);
    case 2: return distinct_for_depth<2>(depth);
    case 4: return distinct_for_depth<4>(depth);
    default: return distinct_for_depth<kGroup>(depth);
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_frh_max_seeds() { return kMaxSeeds; }

REPRO_EXPORT int repro_frh_max_depth() { return kMaxDepth; }

// offsets [n + 1] int64 (offsets[0] = 0, nondecreasing, offsets[n] = nnz),
// items [nnz] int32, out [n, t] int32; seeds: t int32 in host memory,
// 1 <= t <= kMaxSeeds; mask = b - 1 with b a power of two. All
// contiguous. Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int repro_frh_minhash_csr(const void* offsets, const void* items,
                                       long long nnz, const int* seeds,
                                       void* out, int n, int t,
                                       unsigned int mask, void* stream) {
  if (t < 1 || t > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = reinterpret_cast<uintptr_t>(items) % 16 == 0;
  const int grid = (n + kRows - 1) / kRows;
  const CsrFn fn = csr_kernel_for(t);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(items),
      nnz, mixes_of(seeds, t), static_cast<int*>(out), n, t, mask, vec16);
  return static_cast<int>(cudaGetLastError());
}

// items [n, P] int32 (PAD_ID = -1 anywhere), out [n, t] int32; seeds: t
// int32 in host memory, 1 <= t <= kMaxSeeds; mask = b - 1 with b a power
// of two. All contiguous. Launches on `stream` and returns
// cudaGetLastError().
REPRO_EXPORT int repro_frh_minhash(const void* items, const int* seeds,
                                   void* out, int n, int P, int t,
                                   unsigned int mask, void* stream) {
  if (t < 1 || t > kMaxSeeds) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = reinterpret_cast<uintptr_t>(items) % 16 == 0;
  const int grid = (n + kRows - 1) / kRows;
  const PaddedFn fn = padded_kernel_for(t);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(items), mixes_of(seeds, t),
      static_cast<int*>(out), n, P, t, mask, vec16);
  return static_cast<int>(cudaGetLastError());
}

// offsets [n + 1] int64 (offsets[0] = 0, nondecreasing, offsets[n] = nnz),
// items [nnz] int32, out [t, n, depth] int32; seeds: t int32 in host
// memory, 1 <= t <= kMaxSeeds; 1 <= depth <= kMaxDepth; mask = b - 1 with
// b a power of two. All contiguous. One launch for all seeds, on
// `stream`; returns cudaGetLastError().
REPRO_EXPORT int repro_frh_distinct_csr(const void* offsets, const void* items,
                                        long long nnz, const int* seeds,
                                        void* out, int n, int t, int depth,
                                        unsigned int mask, void* stream) {
  if (t < 1 || t > kMaxSeeds || depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = reinterpret_cast<uintptr_t>(items) % 16 == 0;
  const int g = distinct_group(t);
  const dim3 grid((n + kRows - 1) / kRows, (t + g - 1) / g);
  const DistinctFn fn = distinct_kernel_for(t, depth);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(items),
      nnz, mixes_of(seeds, t), static_cast<int*>(out), n, t, depth, mask,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
