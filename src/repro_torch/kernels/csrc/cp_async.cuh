// Asynchronous 4-byte copies from device memory to shared memory
// (cp.async), grouped and waited for by the issuing thread (K4a, K4b, K7,
// and through stage_rows.cuh K1, K2, K5 and K6).  A thread sees its own
// copies after its wait; other threads of the block see them after a
// barrier that follows the wait.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's latest groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
