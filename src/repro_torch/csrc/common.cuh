// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes from repro_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports this so the Python wrapper can name a failed
// launch's error.
#define REPRO_DEFINE_ERROR_STRING                                          \
  REPRO_EXPORT const char* repro_cuda_error_string(int err) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(err));              \
  }

namespace repro {

constexpr int kPadId = -1;

// GoldFinger Jaccard epilogue, bit-for-bit the reference's f32 sequence:
//   union = card_a + card_b - inter;  sim = union > 0 ? inter / max(union, 1) : 0
// The explicit round-to-nearest intrinsics keep the sums and the division
// IEEE whatever the compiler flags (no contraction, no approximate divide).
__device__ __forceinline__ float jaccard_sim(int inter, int card_a,
                                             int card_b) {
  const float fi = static_cast<float>(inter);
  const float uni = __fsub_rn(__fadd_rn(static_cast<float>(card_a),
                                        static_cast<float>(card_b)), fi);
  return uni > 0.0f ? __fdiv_rn(fi, fmaxf(uni, 1.0f)) : 0.0f;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

}  // namespace repro
