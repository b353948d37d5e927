// Probe: three forms of the GoldFinger intersection |A & B| (popcount of
// the AND of two packed W-word fingerprints) over every pair of a batch of
// clusters, in the tiling of goldfinger_knn.cu without its top-k.
//
// Not on any path of the port: repro_torch/bench/intersect_forms.py times
// the forms against each other on the card to choose the one the
// cluster-KNN kernel uses.
//
// Tiling (as goldfinger_knn.cu): one block of 8 warps per (cluster,
// 16-row query tile); warp w takes database tiles of 32 rows w, w+8, ...;
// per tile a warp produces the 16 x 32 intersections as four m16n8 C
// fragments, then adds each row's sum to a checksum (one atomic per row
// and warp), which the probe compares with a plain product.
//   form 0: __popc(a & b) over the W words, CUDA cores;
//   form 1: mma.sync m16n8k256 .b1 AND-popc on the packed words (W padded
//           to a multiple of 8 words with zeros);
//   form 2: mma.sync m16n8k32 .s8 on {0,1} bit planes: the query tile
//           unpacked in shared memory, the database planes (unpacked once
//           into device memory by the caller) read from global memory.
// Forms 0 and 1 stage each warp's database tiles by cp.async, two stages.

#include "common.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kTile = 32;
constexpr int kWarps = 8;

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int F>
__global__ void __launch_bounds__(kWarps * 32)
intersect_kernel(const uint32_t* __restrict__ words,
                 const uint8_t* __restrict__ bits, int* __restrict__ out,
                 int cap, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W8 = (W + 7) & ~7;
  const int ws = W8 + 4;  // row stride: conflict-free fragment reads
  const int K = 32 * W;   // bit planes per row (form 2)
  const int kb = K + 16;  // byte stride of an unpacked query row
  uint32_t* sq = reinterpret_cast<uint32_t*>(smem);    // [16][ws]
  uint32_t* stage = sq + kRows * ws;                   // [warps][2][32][ws]
  uint8_t* sqb = reinterpret_cast<uint8_t*>(stage);    // form 2: [16][kb]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long base = static_cast<long long>(blockIdx.y) * cap;
  const int row0 = blockIdx.x * kRows;
  const bool vec16 = (W & 3) == 0;

  for (int i = threadIdx.x; i < kRows * ws; i += blockDim.x) {
    const int r = i / ws, w = i - r * ws, row = row0 + r;
    sq[i] = (w < W && row < cap) ? words[(base + row) * W + w] : 0u;
  }
  if (F == 2) {
    for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
      const int r = i / K, b = i - r * K, row = row0 + r;
      sqb[r * kb + b] = row < cap ? bits[(base + row) * K + b] : 0;
    }
  }
  __syncthreads();

  uint32_t* my = stage + warp * 2 * kTile * ws;
  const int ntiles = (cap + kTile - 1) / kTile;
  auto issue = [&](int t, int s) {
    uint32_t* dst = my + s * kTile * ws;
    const int col0 = t * kTile;
    if (vec16) {
      const int per = W >> 2;
      for (int i = lane; i < kTile * per; i += 32) {
        const int r = i / per, c = (i - r * per) << 2;
        if (col0 + r < cap)
          repro::cp_async_16(dst + r * ws + c, words + (base + col0 + r) * W + c);
      }
    } else {
      for (int i = lane; i < kTile * W; i += 32) {
        const int r = i / W, c = i - r * W;
        if (col0 + r < cap)
          repro::cp_async_4(dst + r * ws + c, words + (base + col0 + r) * W + c);
      }
    }
  };

  int sum_lo = 0, sum_hi = 0;  // rows g and g + 8
  int t = warp;
  if (F != 2 && t < ntiles) issue(t, 0);
  repro::cp_async_commit();
  for (int it = 0; t < ntiles; ++it, t += kWarps) {
    if (F != 2) {
      if (t + kWarps < ntiles) issue(t + kWarps, (it + 1) & 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
      __syncwarp();
    }
    const uint32_t* sd = my + (it & 1) * kTile * ws;
    int c[4][4] = {};
    if (F == 0) {
      const uint32_t* qa = sq + g * ws;
      const uint32_t* qb = sq + (g + 8) * ws;
      for (int w = 0; w < W; ++w) {
        const uint32_t x = qa[w], y = qb[w];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t d = sd[(j * 8 + tig * 2 + e) * ws + w];
            c[j][e] += __popc(x & d);
            c[j][2 + e] += __popc(y & d);
          }
        }
      }
    } else if (F == 1) {
      for (int kk = 0; kk < W8; kk += 8) {
        const uint32_t a0 = sq[g * ws + kk + tig];
        const uint32_t a1 = sq[(g + 8) * ws + kk + tig];
        const uint32_t a2 = sq[g * ws + kk + tig + 4];
        const uint32_t a3 = sq[(g + 8) * ws + kk + tig + 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* d = sd + (j * 8 + g) * ws + kk + tig;
          mma_b1(c[j], a0, a1, a2, a3, d[0], d[4]);
        }
      }
    } else {
      const int col0 = t * kTile;
      for (int kk = 0; kk < K; kk += 32) {
        const uint8_t* qa = sqb + g * kb + kk + tig * 4;
        const uint8_t* qb = sqb + (g + 8) * kb + kk + tig * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qb);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qb + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = min(col0 + j * 8 + g, cap - 1);
          const uint8_t* d = bits + (base + col) * K + kk + tig * 4;
          mma_s8(c[j], a0, a1, a2, a3,
                 __ldg(reinterpret_cast<const unsigned*>(d)),
                 __ldg(reinterpret_cast<const unsigned*>(d + 16)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (t * kTile + j * 8 + tig * 2 + e < cap) {
          sum_lo += c[j][e];
          sum_hi += c[j][2 + e];
        }
      }
    }
    __syncwarp();
  }
  repro::cp_async_wait<0>();
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
  if (tig == 0) {
    if (row0 + g < cap) atomicAdd(out + base + row0 + g, sum_lo);
    if (row0 + g + 8 < cap) atomicAdd(out + base + row0 + g + 8, sum_hi);
  }
}

template <int F>
int launch(const void* words, const void* bits, void* out, int m, int cap,
           int W, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersect_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((cap + kRows - 1) / kRows, m);
  intersect_kernel<F><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(bits),
      static_cast<int*>(out), cap, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// words uint32 [m, cap, W]; bits uint8 [m, cap, 32 W] (form 2 only);
// out int32 [m, cap], zeroed by the caller, receives for each row the sum
// of its intersections with every row of its cluster.
REPRO_EXPORT int repro_intersect_forms(int form, const void* words,
                                       const void* bits, void* out, int m,
                                       int cap, int W, void* stream) {
  const int ws = ((W + 7) & ~7) + 4;
  size_t smem = sizeof(uint32_t) * static_cast<size_t>(kRows) * ws;
  smem += form == 2 ? static_cast<size_t>(kRows) * (32 * W + 16)
                    : sizeof(uint32_t) * static_cast<size_t>(kWarps) * 2 *
                          kTile * ws;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch<0>(words, bits, out, m, cap, W, smem, s);
    case 1: return launch<1>(words, bits, out, m, cap, W, smem, s);
    case 2: return launch<2>(words, bits, out, m, cap, W, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
