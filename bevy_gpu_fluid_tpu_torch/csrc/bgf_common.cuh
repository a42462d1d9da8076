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

// ---- the pair arithmetic and epilogue shared by the stencil kernels, in
// the Pallas kernels' operation order (the PyTorch twins in
// models/cuda_solver.py repeat it op for op).

constexpr float kEps2 = 1.0e-12f;    // EPS^2 of the softened force gate
constexpr float kGravityY = -9.81f;  // core/params.GRAVITY_Y

// Poly6 pair term max(h^2 - r^2, 0)^3; the max is the r < h gate.
__device__ __forceinline__ float poly6_term(float ddx, float ddy, float h2) {
  const float r2 = ddx * ddx + ddy * ddy;
  const float d = fmaxf(h2 - r2, 0.0f);
  return d * d * d;
}

struct ForceConsts {  // h, -m/2, -10/(pi h^5), mu m 40/(pi h^5)
  float h, m_half, spiky_c, visc_mc;
};

// Adds slot j's pressure + viscosity acceleration on slot i to (ax, ay):
// inv_r = rsqrt(r^2 + EPS^2), hr = max(h - r^2 inv_r, 0) (branch-free gate),
// p_sum = p_i + p_j, (dvx, dvy) = v_j - v_i.
__device__ __forceinline__ void add_pair_accel(float ddx, float ddy,
                                               float p_sum, float ir_j,
                                               float dvx, float dvy,
                                               const ForceConsts& c,
                                               float& ax, float& ay) {
  const float r2 = ddx * ddx + ddy * ddy;
  const float inv_r = rsqrtf(r2 + kEps2);
  const float dist = r2 * inv_r;
  const float hr = fmaxf(c.h - dist, 0.0f);
  const float fac_p = c.m_half * p_sum * ir_j * (c.spiky_c * hr * hr * inv_r);
  const float fac_v = c.visc_mc * ir_j * hr;
  ax += fac_p * ddx + fac_v * dvx;
  ay += fac_p * ddy + fac_v * dvy;
}

struct IntegrateConsts {
  float dt, x_min, x_max, bounce, floor_y;
};

// Semi-implicit Euler with gravity and the bounce box, masked to live slots
// (x < 1e8: a dead slot keeps its position and gets zero velocity).
// Writes (x, y, vx, vy) and returns whether the slot is live.
__device__ __forceinline__ bool integrate(float xi, float yi, float vxi,
                                          float vyi, float ax, float ay,
                                          const IntegrateConsts& c, float& x,
                                          float& y, float& vx, float& vy) {
  const bool live = xi < 1.0e8f;
  vx = vxi + ax * c.dt;
  vy = vyi + (ay + kGravityY) * c.dt;
  x = xi + vx * c.dt;
  y = yi + vy * c.dt;
  if (y < c.floor_y) { y = c.floor_y; vy = vy * c.bounce; }
  if (x > c.x_max) { x = c.x_max; vx = vx * c.bounce; }
  if (x < c.x_min) { x = c.x_min; vx = vx * c.bounce; }
  if (!live) { x = xi; y = yi; vx = 0.0f; vy = 0.0f; }
  return live;
}

// Block max of d2 >= 0 (warp shuffles, then shared memory), then one
// atomicMax on the float bits into *bits (non-negative floats order as
// unsigned ints; the host zeroes it on the same stream).  Every thread of a
// kThreads-wide block must call it.
__device__ __forceinline__ void block_max_atomic(float d2,
                                                 unsigned int* bits) {
  for (int off = 16; off > 0; off >>= 1)
    d2 = fmaxf(d2, __shfl_xor_sync(0xffffffffu, d2, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = d2;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const unsigned int b = __float_as_uint(v);
    if (lane == 0 && b != 0u) atomicMax(bits, b);
  }
}

}  // namespace bgf
