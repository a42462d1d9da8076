// K1: SPH density over the dense slot grid.
//
// Replaces the TPU kernel `_density_kernel` / `density_pallas`
// (bevy_gpu_fluid_tpu/models/pallas_solver.py:224, :854).  Per slot:
//   rho_i = coeff * sum_j max(h^2 - r_ij^2, 0)^3,  coeff = m * 4 / (pi h^8)
// over the 3x3 neighbour cells x kmax slots, kj outer, then dx, then dy --
// the Pallas kernel's order, so the sum runs in the same order as the
// PyTorch twin (models/cuda_solver.density_torch).
//
// What bounds it on the H100: load issue, not device memory.  Each pair
// reads two floats of a neighbour slot (8 B) for ~8 flops; the 3x3 x kmax
// neighbour slots of a warp's 32 slots are 32 consecutive floats of one
// row, re-read by the 9 neighbouring warps, so the taps hit L1/L2 and
// device memory sees one read of x and y and one write of rho: 43 MB at
// the 1M-particle shapes [696, 8, 640], 0.013 ms at 3.35 TB/s, against
// 0.102 ms measured (H100 80GB HBM3, 700 W).
// Design: one thread per output slot, threads along nx_pad (coalesced; a
// warp shares row and slot index, so the data-dependent kj bound never
// diverges inside a warp).  The launch covers the ghost blocks too and
// writes 0 there, the fill the forces kernel's halo expects.  No shared
// memory tiles yet: a halo tile in shared memory is later work.

#include "bgf_common.cuh"

namespace {

__global__ void density_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const int* __restrict__ occ,
                               float* __restrict__ rho, int cap, int nx_pad,
                               int tb, int nb, long long total, float h2,
                               float coeff) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= total) return;
  const int col = static_cast<int>(t % nx_pad);
  const int row = static_cast<int>(t / nx_pad / cap);
  if (!bgf::interior_row(row, tb, nb)) {
    rho[t] = 0.0f;
    return;
  }
  const int kmax = bgf::block_kmax(occ, nb, row / tb - 1);
  const float xi = x[t];
  const float yi = y[t];
  float acc = 0.0f;
  for (int kj = 0; kj < kmax; ++kj) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int c = bgf::wrap_col(col + dx, nx_pad);
      for (int dy = -1; dy <= 1; ++dy) {
        const long long j =
            (static_cast<long long>(row + dy) * cap + kj) * nx_pad + c;
        acc += bgf::poly6_term(xi - x[j], yi - y[j], h2);
      }
    }
  }
  rho[t] = acc * coeff;
}

}  // namespace

extern "C" int bgf_density(const float* x, const float* y, const int* occ,
                           float* rho, int ny_pad, int cap, int nx_pad,
                           int tb, int nb, float h2, float coeff,
                           cudaStream_t stream) {
  const long long total = static_cast<long long>(ny_pad) * cap * nx_pad;
  density_kernel<<<bgf::blocks_for(total), bgf::kThreads, 0, stream>>>(
      x, y, occ, rho, cap, nx_pad, tb, nb, total, h2, coeff);
  return static_cast<int>(cudaGetLastError());
}
