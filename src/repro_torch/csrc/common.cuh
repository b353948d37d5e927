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

// Asynchronous global -> shared copies (cp.async). A thread's copies are
// visible to it after cp_async_wait; other threads also need a barrier.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
