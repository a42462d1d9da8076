// K8: unfused SPH pressure + viscosity accelerations.
//
// Replaces the TPU kernel `_forces_kernel` / `forces_pallas`
// (bevy_gpu_fluid_tpu/models/pallas_solver.py:296, :930).  Per slot i:
//   p = k * max(rho - rho0, 0), 1/rho = 1 / max(rho, 1e-12)   (EOS in-kernel)
//   a_i = sum_j  m_half (p_i + p_j) / rho_j * spiky_c hr^2 inv_r * (r_i - r_j)
//              + visc_mc / rho_j * hr * (v_j - v_i)
// with the softened gate inv_r = rsqrt(r^2 + EPS^2), hr = max(h - r^2 inv_r,
// 0), over the 3x3 neighbour cells x kmax slots in (kj, dx, dy) order: K2's
// pair loop (bgf::add_pair_accel, shared with K2 and K5) without the
// integrate epilogue or the displacement reduction.  Writes ax, ay.  The TPU
// kernel leaves the ghost blocks of its outputs unwritten; this launch
// covers them and writes 0 there.  Gravity is the caller's (the eager step
// glue adds it per particle, the Session's unfused step in its integrate).
//
// What bounds it on the H100: instruction issue, as K2.  Per pair ~29
// flops, an rsqrt and one IEEE division (1/rho_j per tap), and five
// neighbour floats that hit L1/L2.  Device memory sees 5 planes read and 2
// written: 100 MB at the 1M-particle shapes [696, 8, 640], 0.030 ms at 3.35
// TB/s; the force taps are ~1.06 GFLOP there, 0.016 ms at 67 TFLOP/s.
// Design: K2's, one thread per output slot along nx_pad (coalesced; the
// data-dependent kj bound is uniform in a warp, so it never diverges).

#include "bgf_common.cuh"

namespace {

__global__ void forces_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ vx,
                              const float* __restrict__ vy,
                              const float* __restrict__ rho,
                              const int* __restrict__ occ,
                              float* __restrict__ ax_out,
                              float* __restrict__ ay_out, int cap, int nx_pad,
                              int tb, int nb, long long total,
                              bgf::ForceConsts fc, float rho0, float k) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= total) return;
  const int col = static_cast<int>(t % nx_pad);
  const int row = static_cast<int>(t / nx_pad / cap);
  float ax = 0.0f;
  float ay = 0.0f;
  if (bgf::interior_row(row, tb, nb)) {
    const int kmax = bgf::block_kmax(occ, nb, row / tb - 1);
    const float xi = x[t];
    const float yi = y[t];
    const float vxi = vx[t];
    const float vyi = vy[t];
    const float p_i = k * fmaxf(rho[t] - rho0, 0.0f);
    for (int kj = 0; kj < kmax; ++kj) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int c = bgf::wrap_col(col + dx, nx_pad);
        for (int dy = -1; dy <= 1; ++dy) {
          const long long j =
              (static_cast<long long>(row + dy) * cap + kj) * nx_pad + c;
          const float rho_j = rho[j];
          bgf::add_pair_accel(xi - x[j], yi - y[j],
                              p_i + k * fmaxf(rho_j - rho0, 0.0f),
                              1.0f / fmaxf(rho_j, 1.0e-12f), vx[j] - vxi,
                              vy[j] - vyi, fc, ax, ay);
        }
      }
    }
  }
  ax_out[t] = ax;
  ay_out[t] = ay;
}

}  // namespace

extern "C" int bgf_forces(const float* x, const float* y, const float* vx,
                          const float* vy, const float* rho, const int* occ,
                          float* ax, float* ay, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, float h, float m_half,
                          float spiky_c, float visc_mc, float rho0, float k,
                          cudaStream_t stream) {
  const long long total = static_cast<long long>(ny_pad) * cap * nx_pad;
  forces_kernel<<<bgf::blocks_for(total), bgf::kThreads, 0, stream>>>(
      x, y, vx, vy, rho, occ, ax, ay, cap, nx_pad, tb, nb, total,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k);
  return static_cast<int>(cudaGetLastError());
}
