// Asynchronous copies into shared memory and the stage ring built on them, shared by the
// port's kernels (nb1d_infer.cu, nb1d_train.cu). sm_80 and later; built for sm_90a.
#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes from global to shared memory, cached in L2 only; both addresses 16-byte aligned
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups (the newest ones) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kStages = 3;  // cp.async ring depth: stages s+1, s+2 load while s multiplies

// Runs stages 0 .. S-1 through the ring: fetch(s, buf) starts the cp.async copies of stage s into
// buffer buf (and the zero fill of what it does not copy), fixup(s, buf) runs on each thread's
// own copies once they have landed (before the barrier that publishes them), compute(s, buf)
// multiplies. One barrier per stage: the buffer refilled after it was last read before it.
template <typename Fetch, typename Fixup, typename Compute>
__device__ __forceinline__ void pipeline(int S, Fetch fetch, Fixup fixup, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < S) fetch(s, s);
    cp_async_commit();  // empty groups keep the count: wait<kStages-2> means "stage s landed"
  }
  int buf = 0;
  for (int s = 0; s < S; ++s) {
    cp_async_wait<kStages - 2>();
    fixup(s, buf);
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < S) fetch(next, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    compute(s, buf);
    buf = buf == kStages - 1 ? 0 : buf + 1;
  }
  __syncthreads();  // the buffers are free for the caller's next use
}

}  // namespace
