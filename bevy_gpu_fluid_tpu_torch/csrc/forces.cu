// K8: unfused SPH pressure + viscosity accelerations.
//
// Replaces the TPU kernel `_forces_kernel` / `forces_pallas`
// (bevy_gpu_fluid_tpu/models/pallas_solver.py:296, :930).  Per slot i:
//   p = k * max(rho - rho0, 0), 1/rho = 1 / max(rho, 1e-12)   (EOS in-kernel)
//   a_i = sum_j  m_half (p_i + p_j) / rho_j * spiky_c hr^2 inv_r * (r_i - r_j)
//              + visc_mc / rho_j * hr * (v_j - v_i)
// with the softened gate inv_r = rsqrt(r^2 + EPS^2), hr = max(h - r^2 inv_r,
// 0), over the 3x3 neighbour cells x kmax slots in (kj, dx, dy) order: K2's
// pair loop without the integrate epilogue or the displacement reduction.
// Writes ax, ay.  The TPU kernel leaves the ghost blocks of its outputs
// unwritten; this launch covers them and writes 0 there.  Gravity is the
// caller's (the eager step glue adds it per particle, the Session's unfused
// step in its integrate).
//
// What bounds it on the H100.  The bytes bound is 7 planes (5 read, 2
// written): 100 MB at the 1M Session's planes [696, 8, 640], 235 MB at the
// eager 1M planes [1024, 8, 1024] (0.070 ms at 3.35 TB/s).  A thread per
// slot over the whole plane took 0.64 ms on the eager planes (0.28 on the
// Session's), on instruction issue: every slot, ~88% of them dead there,
// ran all 9 x kmax taps with five gathers, the neighbour's EOS and an IEEE
// division at every tap.
//
// Design: K2's halo tile (csrc/forces_integrate.cu, bgf_common.cuh) without
// its epilogue.  A block stages its window once in shared memory,
// (x, y, vx, vy) as a float4 and (p, 1/rho) as a float2 taken once per
// staged slot (bgf::stage_force_window), counts each window cell's live
// prefix and lists the tile's live (cell, slot) pairs; a thread per live
// pair sums its taps up to the largest count of its 9 cells
// (bgf::tile_accel) and writes ax, ay.  A dead slot's accelerations are
// exactly +0 in the twin (its FAR-FAR taps have ddx = ddy = 0 and dv = 0,
// its taps on live slots hr = 0: every term is +-0 added to +0; pinned by
// tests/test_torch_stencil_tiles.py), so a coalesced pass over the tile's
// slots writes 0 there with no taps.

#include "bgf_common.cuh"

namespace {

constexpr int kBlock = bgf::kThreads;  // 256, as K2

// Dynamic shared memory: the (x, y, vx, vy) and (p, 1/rho) windows, the
// window counts, the pair list and the pair count (K2's).
int forces_smem(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols * (16 + 8) +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 + 4;
}

__global__ void __launch_bounds__(kBlock) forces_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const int* __restrict__ occ,
    float* __restrict__ ax_out, float* __restrict__ ay_out, int cap,
    int nx_pad, int tb, int nb, bgf::ForceConsts fc, float rho0, float k) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
    });
    return;
  }
  extern __shared__ float4 win[];  // kWinRows x kmax x kWinCols
  float2* eos = reinterpret_cast<float2*>(win + kWinRows * cap * kWinCols);
  int* cnt = reinterpret_cast<int*>(eos + kWinRows * cap * kWinCols);
  int* pairs = cnt + kWinRows * kWinCols;
  int* n_pairs = pairs + kTileCells * cap;

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  stage_force_window<kBlock>(t, kmax, cap, nx_pad, base, x, y, vx, vy, rho,
                             rho0, k, win, eos, cnt);
  __syncthreads();
  if (threadIdx.x < 32) list_pairs(t, kmax, cnt, pairs, n_pairs);
  __syncthreads();

  const int np = *n_pairs;
  const int rs = kmax * kWinCols;  // window row stride
  for (int p = threadIdx.x; p < np; p += kBlock) {
    const int c = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = c / kTileCols;
    const int tc = c - tr * kTileCols;
    const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
    const float2 a = tile_accel(win, eos, tr * rs + tc, rs,
                                neighbour_counts(cnt, tr, tc).x, win[own_i],
                                eos[own_i].x, fc);
    const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
    ax_out[g] = a.x;
    ay_out[g] = a.y;
  }
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1]) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
    }
  });
}

}  // namespace

extern "C" int bgf_forces(const float* x, const float* y, const float* vx,
                          const float* vy, const float* rho, const int* occ,
                          float* ax, float* ay, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, float h, float m_half,
                          float spiky_c, float visc_mc, float rho0, float k,
                          cudaStream_t stream) {
  const int smem = forces_smem(cap);
  const cudaError_t err = bgf::allow_smem(forces_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forces_kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kBlock, smem,
                  stream>>>(x, y, vx, vy, rho, occ, ax, ay, cap, nx_pad, tb,
                            nb, bgf::ForceConsts{h, m_half, spiky_c, visc_mc},
                            rho0, k);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_forces_occupancy(int cap, int* out) {
  return bgf::report_occupancy(forces_kernel, kBlock, forces_smem(cap), out);
}
