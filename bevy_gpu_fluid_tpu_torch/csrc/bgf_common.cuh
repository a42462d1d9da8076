// Shared helpers of the dense-grid stencil kernels.
//
// Dense plane layout (the JAX package's, kept as is): float32 or int32
// [ny_pad, cap, nx_pad], element (row, k, col) at ((row * cap + k) * nx_pad
// + col).  Interior rows are [tb, (nb + 1) * tb); the first and last tb
// rows are ghost blocks.  A stencil at an interior row reads rows row-1 and
// row+1, so the halo rows tb-1 and (nb+1)*tb come from the ghost blocks.
// Neighbour columns wrap modulo nx_pad (the TPU kernels' lane roll); the
// ghost columns hold the FAR sentinel, so a wrapped tap contributes 0.
#pragma once

#include <cuda_runtime.h>

namespace bgf {

constexpr int kThreads = 256;       // threads per block, all kernels
constexpr float kFar = 1.0e9f;      // empty-slot sentinel (ops/binning.FAR)
constexpr float kHalfFar = 5.0e8f;  // liveness gate: x < FAR / 2

__device__ __forceinline__ int wrap_col(int c, int nx_pad) {
  return c < 0 ? c + nx_pad : (c >= nx_pad ? c - nx_pad : c);
}

// Slot-loop bound of interior row block r: the max occupancy over the three
// row shifts (occ is int32 [3, nb], ops/reslot.block_kmax3).
__device__ __forceinline__ int block_kmax(const int* __restrict__ occ,
                                          int nb, int r) {
  return max(max(occ[r], occ[nb + r]), occ[2 * nb + r]);
}

__device__ __forceinline__ bool interior_row(int row, int tb, int nb) {
  return row >= tb && row < (nb + 1) * tb;
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace bgf
