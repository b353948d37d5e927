// Fused multi-seed FastRandomHash over padded profiles.
//
// Replaces the TPU kernel src/repro/kernels/frh_minhash/frh_minhash.py
// ::minhash_pallas (body _minhash_kernel), reached through
// kernels/frh_minhash/ops.dataset_minhash.
//
//   H_s(u) = min over the items of u of fmix32(item ^ (seed_s + 1) * 0x9E3779B9) & (b - 1)
//
// with PAD items (-1) ignored and NO_HASH (2^31 - 1) for an empty row; b is
// a power of two, so the modulo is a mask. All arithmetic is uint32 and
// wraps, as the reference's.
//
// Design. One warp per user row: its lanes stride over the row's P items
// (coalesced 128-byte reads), each keeping a running minimum for every one
// of the t seeds in registers, so the row is read from memory once for all
// t seeds. A warp min-shuffle per seed reduces the lanes, and lane s writes
// seed s's value.
//
// What bounds it: the padded profile matrix, n * P * 4 bytes read once,
// against ~11 integer operations per (item, seed) on the CUDA cores. With
// the paper's t = 8 and profiles padded to the longest one, reading the
// matrix dominates.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per user row
constexpr int kMaxSeeds = 32;         // one seed per lane at the write
constexpr uint32_t kNoHash = 0x7fffffffu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
frh_minhash_kernel(const int* __restrict__ items, const int* __restrict__ seeds,
                   int* __restrict__ out, int n, int P, int t,
                   uint32_t mask) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRows +
                        (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  uint32_t mix[kMaxSeeds];
  uint32_t best[kMaxSeeds];
#pragma unroll
  for (int s = 0; s < kMaxSeeds; ++s) {
    mix[s] = s < t ? (static_cast<uint32_t>(seeds[s]) + 1u) * 0x9e3779b9u
                   : 0u;
    best[s] = kNoHash;
  }
  const int* prof = items + row * P;
  for (int j = lane; j < P; j += 32) {
    const int item = prof[j];
    if (item == repro::kPadId) continue;
    const uint32_t u = static_cast<uint32_t>(item);
#pragma unroll
    for (int s = 0; s < kMaxSeeds; ++s)
      if (s < t) best[s] = min(best[s], fmix32(u ^ mix[s]) & mask);
  }
  uint32_t mine = kNoHash;
#pragma unroll
  for (int s = 0; s < kMaxSeeds; ++s) {
    if (s < t) {
      uint32_t v = best[s];
      for (int off = 16; off > 0; off >>= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == s) mine = v;
    }
  }
  if (lane < t) out[row * t + lane] = static_cast<int>(mine);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_frh_max_seeds() { return kMaxSeeds; }

// items [n, P] int32 (PAD_ID = -1 padded), seeds [t] int32, out [n, t]
// int32; 1 <= t <= kMaxSeeds, mask = b - 1 with b a power of two. All
// contiguous. Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int repro_frh_minhash(const void* items, const void* seeds,
                                   void* out, int n, int P, int t,
                                   unsigned int mask, void* stream) {
  const int grid = (n + kRows - 1) / kRows;
  frh_minhash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(items), static_cast<const int*>(seeds),
      static_cast<int*>(out), n, P, t, mask);
  return static_cast<int>(cudaGetLastError());
}
