// K2: SPH forces + semi-implicit Euler + bounce box + skin displacement.
//
// Replaces the TPU kernel `_forces_integrate_kernel` /
// `forces_integrate_pallas` (bevy_gpu_fluid_tpu/models/pallas_solver.py:400,
// :961), ref-based trigger, no lane window.  Per live slot i:
//   p = k * max(rho - rho0, 0), 1/rho = 1 / max(rho, 1e-12)   (EOS in-kernel)
//   inv_r = rsqrt(r^2 + EPS^2), hr = max(h - r^2 * inv_r, 0)  (softened gate)
//   a_i = sum_j  m_half (p_i + p_j) / rho_j * spiky_c hr^2 inv_r * (r_i - r_j)
//              + visc_mc / rho_j * hr * (v_j - v_i)
// over the 3x3 neighbour cells x kmax slots in (kj, dx, dy) order, then
// v += (a + g) dt, x += v dt, the floor/wall clamp with bounce, all masked
// to live slots (x < 1e8) so FAR stays FAR; and the max over live slots of
// |x_new - x_ref|^2, the next step's rebin trigger.  Accelerations never
// reach device memory.
//
// What bounds it on the H100: instruction issue, not device memory.  Per
// pair ~35 flops, an rsqrt and one IEEE division (1/rho_j is derived per
// tap, as no plane of it is stored), and five neighbour floats (x, y, vx,
// vy, rho) that hit L1/L2 as in K1.  Device memory sees 11 planes (7 read,
// 4 written): 157 MB at the 1M-particle shapes [696, 8, 640], 0.05 ms at
// 3.35 TB/s, against 0.415 ms measured (H100 80GB HBM3, 700 W).
// Design: one thread per output slot, threads along nx_pad (coalesced, no
// divergence on the kj bound inside a warp).  The displacement max is a
// warp-shuffle and shared-memory reduction per block, then one atomicMax on
// the float bits (all values are >= +0, so integer order is float order) into
// a scalar the host zeroes on the same stream (bgf::block_max_atomic).  The
// launch covers the ghost blocks and writes their fills (FAR positions, zero
// velocities).  The pair term and the epilogue are bgf_common.cuh's, shared
// with K5.

#include "bgf_common.cuh"

namespace {

__global__ void forces_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const float* __restrict__ ref_x,
    const float* __restrict__ ref_y, const int* __restrict__ occ,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, long long total, bgf::ForceConsts fc,
    float rho0, float k, bgf::IntegrateConsts ic) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  float d2 = 0.0f;
  if (t < total) {
    const int col = static_cast<int>(t % nx_pad);
    const int row = static_cast<int>(t / nx_pad / cap);
    if (!bgf::interior_row(row, tb, nb)) {
      ox[t] = bgf::kFar;
      oy[t] = bgf::kFar;
      ovx[t] = 0.0f;
      ovy[t] = 0.0f;
    } else {
      const int kmax = bgf::block_kmax(occ, nb, row / tb - 1);
      const float xi = x[t];
      const float yi = y[t];
      const float vxi = vx[t];
      const float vyi = vy[t];
      const float p_i = k * fmaxf(rho[t] - rho0, 0.0f);
      float ax = 0.0f;
      float ay = 0.0f;
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
      float nx, ny, nvx, nvy;
      const bool live =
          bgf::integrate(xi, yi, vxi, vyi, ax, ay, ic, nx, ny, nvx, nvy);
      ox[t] = nx;
      oy[t] = ny;
      ovx[t] = nvx;
      ovy[t] = nvy;
      if (live) {
        const float drx = nx - ref_x[t];
        const float dry = ny - ref_y[t];
        d2 = drx * drx + dry * dry;
      }
    }
  }
  bgf::block_max_atomic(d2, disp_bits);
}

}  // namespace

extern "C" int bgf_forces_integrate(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* rho, const float* ref_x, const float* ref_y, const int* occ,
    float* ox, float* oy, float* ovx, float* ovy, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, float h, float m_half,
    float spiky_c, float visc_mc, float rho0, float k, float dt, float x_min,
    float x_max, float bounce, float floor_y, cudaStream_t stream) {
  const long long total = static_cast<long long>(ny_pad) * cap * nx_pad;
  cudaError_t err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  forces_integrate_kernel<<<bgf::blocks_for(total), bgf::kThreads, 0,
                            stream>>>(
      x, y, vx, vy, rho, ref_x, ref_y, occ, ox, oy, ovx, ovy,
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb, total,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}
