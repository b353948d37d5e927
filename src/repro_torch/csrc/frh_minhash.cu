// Fused multi-seed FastRandomHash of users' profiles.
//
// Replaces the TPU kernel src/repro/kernels/frh_minhash/frh_minhash.py
// ::minhash_pallas (body _minhash_kernel), reached through
// kernels/frh_minhash/ops.dataset_minhash.
//
//   H_s(u) = min over the items of u of fmix32(item ^ (seed_s + 1) * 0x9E3779B9) & (b - 1)
//
// NO_HASH (2^31 - 1) for an empty profile; b is a power of two, so the
// modulo is a mask. All arithmetic is uint32 and wraps, as the reference's.
// Two entries share the device code:
//   - repro_frh_minhash_csr: the profiles as CSR (offsets int64[n + 1],
//     items int32[nnz]), what dataset_minhash passes: every item is read
//     once, and nothing else;
//   - repro_frh_minhash: profiles padded to P items with PAD (-1), the
//     TPU kernel's own signature; PAD may sit anywhere in a row, so the
//     whole [n, P] matrix is read and PAD items are skipped.
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
// What bounds it: for the CSR entry the items, 4 bytes each, against ~11
// integer operations per (item, seed) on the CUDA cores; at ml1M@1.0 and
// t = 8 the two are about equal (0.0009 ms each), under the cost of one
// small launch. Rows are ragged (a mean of 113 items, a longest of 981),
// so a warp per user is balanced enough at that size: a longest row takes
// four rounds of loads where a mean one takes one.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per user row
constexpr int kMaxSeeds = 32;         // one seed per lane at the write
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

// Items [s, e) of `items` (nnz of them in all) hashed under every seed by
// the warp: lane s writes seed s's minimum to out[0 .. t). kPad skips PAD
// items; vec16: the items are 16-byte aligned. A lane takes vectors
// v0 + lane and v0 + lane + 32 of each 64 (both loads in flight, and the
// next 64's issued before these are hashed), hashes
// their 4 items under each seed and ORs each item's dead mask into its
// hash, so that no branch splits the warp; a vector no lane needs is
// skipped by all.
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
  auto take = [&](int4 x, int o) {
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
  };
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
  warp_min_write<T>(best, t, lane, out);
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

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_frh_max_seeds() { return kMaxSeeds; }

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
