// Asynchronous global -> shared copies (Ampere's cp.async, on Hopper too)
// for the kernels that stage a window without passing it through
// registers: the slot-major density (exp_tlayout.cu's T2; T1 and T3 copy
// by TMA boxes, bgf_tma.cuh).
//
// A copy is 4 bytes, one float, cached in L1 (cp.async.ca): the halo
// window's first column, col0 - 1, is neither 16-byte aligned nor in
// bounds at the left edge (it wraps to a ghost column), so a wider copy
// or a TMA box (which fills out-of-bounds elements with 0 or NaN, never
// FAR) would need a patch of that column before the stage is read.  A
// thread's copies complete in commit-group order: cp_async_wait<n> waits
// until at most n of its groups are in flight; a __syncthreads after it
// makes every thread's landed copies visible to the block.
#pragma once

#include <cuda_runtime.h>

namespace bgf {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kInFlight>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kInFlight) : "memory");
}

}  // namespace bgf
