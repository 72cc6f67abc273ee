// Asynchronous copies into shared memory, the stage ring built on them and ldmatrix, shared by
// the port's kernels (nb1d_infer.cu, nb1d_train.cu). sm_80 and later; built for sm_90a.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each) from shared memory, row
// addresses from lanes 0-7, 8-15, 16-23, 24-31; lane l receives 32 bits of each matrix, row
// l/4, bytes 4*(l%4) .. +3
template <typename T>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const T* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// wait until at most N groups (the newest ones) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kStages = 3;  // cp.async ring depth: stages s+1, s+2 load while s multiplies

// Runs stages 0 .. S-1 through a ring of DEPTH buffers: fetch(s, buf) starts the cp.async copies
// of stage s into buffer buf (and the zero fill of what it does not copy), fixup(s, buf) runs on
// each thread's own copies once they have landed (before the barrier that publishes them),
// compute(s, buf) multiplies. One barrier per stage: the buffer refilled after it was last read
// before it.
template <int DEPTH = kStages, typename Fetch, typename Fixup, typename Compute>
__device__ __forceinline__ void pipeline(int S, Fetch fetch, Fixup fixup, Compute compute) {
  static_assert(DEPTH >= 2, "a ring of at least two buffers");
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {
    if (s < S) fetch(s, s);
    cp_async_commit();  // empty groups keep the count: wait<DEPTH-2> means "stage s landed"
  }
  int buf = 0;
  for (int s = 0; s < S; ++s) {
    cp_async_wait<DEPTH - 2>();
    fixup(s, buf);
    __syncthreads();
    const int next = s + DEPTH - 1;
    if (next < S) fetch(next, buf == 0 ? DEPTH - 1 : buf - 1);
    cp_async_commit();
    compute(s, buf);
    buf = buf == DEPTH - 1 ? 0 : buf + 1;
  }
  __syncthreads();  // the buffers are free for the caller's next use
}

}  // namespace
