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
// a scalar the host zeroes on the same stream.  The launch covers the ghost
// blocks and writes their fills (FAR positions, zero velocities).

#include "bgf_common.cuh"

namespace {

constexpr float kEps2 = 1.0e-12f;    // EPS^2, EPS = 1e-6
constexpr float kGravityY = -9.81f;  // core/params.GRAVITY_Y

__global__ void forces_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const float* __restrict__ ref_x,
    const float* __restrict__ ref_y, const int* __restrict__ occ,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, long long total, float h, float m_half,
    float spiky_c, float visc_mc, float rho0, float k, float dt, float x_min,
    float x_max, float bounce, float floor_y) {
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
            const float p_j = k * fmaxf(rho_j - rho0, 0.0f);
            const float ir_j = 1.0f / fmaxf(rho_j, 1.0e-12f);
            const float ddx = xi - x[j];
            const float ddy = yi - y[j];
            const float r2 = ddx * ddx + ddy * ddy;
            const float inv_r = rsqrtf(r2 + kEps2);
            const float dist = r2 * inv_r;
            const float hr = fmaxf(h - dist, 0.0f);
            const float fac_p =
                m_half * (p_i + p_j) * ir_j * (spiky_c * hr * hr * inv_r);
            const float fac_v = visc_mc * ir_j * hr;
            ax += fac_p * ddx + fac_v * (vx[j] - vxi);
            ay += fac_p * ddy + fac_v * (vy[j] - vyi);
          }
        }
      }
      const bool live = xi < 1.0e8f;
      float nvx = vxi + ax * dt;
      float nvy = vyi + (ay + kGravityY) * dt;
      float nx = xi + nvx * dt;
      float ny = yi + nvy * dt;
      if (ny < floor_y) { ny = floor_y; nvy = nvy * bounce; }
      if (nx > x_max) { nx = x_max; nvx = nvx * bounce; }
      if (nx < x_min) { nx = x_min; nvx = nvx * bounce; }
      if (!live) { nx = xi; ny = yi; nvx = 0.0f; nvy = 0.0f; }
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
  // block max of d2, then one atomic per block
  for (int off = 16; off > 0; off >>= 1)
    d2 = fmaxf(d2, __shfl_xor_sync(0xffffffffu, d2, off));
  __shared__ float warp_max[bgf::kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = d2;
  __syncthreads();
  if (warp == 0) {
    float v = lane < bgf::kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const unsigned int bits = __float_as_uint(v);
    if (lane == 0 && bits != 0u) atomicMax(disp_bits, bits);
  }
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
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb, total, h,
      m_half, spiky_c, visc_mc, rho0, k, dt, x_min, x_max, bounce, floor_y);
  return static_cast<int>(cudaGetLastError());
}
