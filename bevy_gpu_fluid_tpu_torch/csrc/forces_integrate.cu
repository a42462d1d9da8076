// K2: SPH forces + semi-implicit Euler + bounce box + skin displacement.
//
// Replaces the TPU kernel `_forces_integrate_kernel` /
// `forces_integrate_pallas` (bevy_gpu_fluid_tpu/models/pallas_solver.py:400,
// :961), both triggers, with its lane window.  Per live slot i:
//   p = k * max(rho - rho0, 0), 1/rho = 1 / max(rho, 1e-12)   (EOS in-kernel)
//   inv_r = rsqrt(r^2 + EPS^2), hr = max(h - r^2 * inv_r, 0)  (softened gate)
//   a_i = sum_j  m_half (p_i + p_j) / rho_j * spiky_c hr^2 inv_r * (r_i - r_j)
//              + visc_mc / rho_j * hr * (v_j - v_i)
// over the 3x3 neighbour cells x kmax slots in (kj, dx, dy) order, then
// v += (a + g) dt, x += v dt, the floor/wall clamp with bounce, all masked
// to live slots (x < 1e8) so FAR stays FAR; and the max over live slots of
// |x_new - x_ref|^2, the next step's rebin trigger.  Accelerations never
// reach device memory.  The REFLESS variant (kRefless, the memory-ceiling
// trigger; pallas_solver.py:626-632) measures against the slot's own old
// position instead, which the thread already holds: it reads no reference
// plane (the launcher takes null reference pointers), so its bytes are two
// planes fewer, and the driver sums the square roots of the step maxima.
// The squared distance is rounded term by term (no FMA contraction), so the
// max equals the one a PyTorch pass over the kernel's own outputs takes.
// The max covers the lanes [disp_lo, disp_hi) only (`disp_lanes`,
// pallas_solver.py:646-652; both triggers): a slab of the sharded solver
// passes its real columns [1, nx_local + 1), so the live neighbour copies
// in its ghost columns, whose reference is FAR, stay out of the trigger.
// The single-card path passes [0, nx_pad).
//
// What bounds it on the H100.  The bytes bound is 11 planes (7 read, 4
// written; 9 refless): 157 MB at the 1M-particle shapes [696, 8, 640],
// 0.047 ms at 3.35 TB/s.  A thread per slot over the whole plane took
// 0.315 ms on instruction issue: every slot, 72% of them dead at 1M, ran all
// 9 x kmax taps of ~45 instructions, with the neighbour's EOS and an IEEE
// division taken again at every tap.  The tiled kernel runs ~0.08 ms at 1M
// and ~5.6 ms at 96M (H100 80GB HBM3, 700 W; PERF.md).  At 96M its memory
// phases alone (staging, the plane writes) take ~3.7 ms and its taps ~2.9
// ms of issue, overlapped only by the blocks resident beside each other:
// occupancy binds.  So the kernel is built for 5 blocks per SM
// (__launch_bounds__: 48 registers, no spill; its 41 KB of shared memory
// allows 5), and its dead-slot pass reads nothing from device memory.
// The walk tile of bgf_walk.cuh (16-byte staging, two slots a thread) was
// measured in its place and lost where the counts vary (PERF.md): its
// 57-64 registers leave 4 blocks per SM.
//
// Design: the halo tile of bgf_common.cuh.  A block stages its window once
// in shared memory, coalesced along nx_pad with the columns wrapped:
// (x, y, vx, vy) as a float4 and the EOS pair (p_j, 1/rho_j) as a float2,
// taken once per staged slot with the twin's float operations, so they are
// the bits the twin uses (bgf::stage_force_window, shared with K8).  It
// counts each window cell's live prefix and lists the tile's live (cell,
// slot) pairs.  A thread per live pair sums its taps in (kj, dx, dy) order
// up to the largest count of its 9 cells (bgf::tile_accel: a candidate past
// its own cell's count holds FAR: hr = 0, its term is exactly 0 and the
// sums never hold -0), then runs the epilogue (bgf::integrate) and keeps
// the displacement max.  A dead slot gets what the masked epilogue gives
// it, x and y unchanged and zero velocity, from a coalesced pass over the
// tile's slots with no taps that takes x and y from the staged window
// (below kmax) or writes FAR (at or past it, where every slot holds FAR:
// live slots are a prefix of each cell), as K5 and T1 take them.  The max
// is a block reduction and one atomicMax on the float bits (all values are
// >= +0, so integer order is float order) into a scalar the host zeroes on
// the same stream (bgf::block_max_atomic).  Offsets inside the window are
// 32-bit from one 64-bit base per block.  The launch covers the ghost
// blocks and writes their fills (FAR positions, zero velocities).  The pair
// term and the epilogue are bgf_common.cuh's, shared with K5 and K8.

#include "bgf_common.cuh"

namespace {

constexpr int kBlock = bgf::kThreads;  // 256 (128 measured slower)
constexpr int kMinBlocks = 5;          // blocks per SM it is built for

// Dynamic shared memory: the (x, y, vx, vy) and (p, 1/rho) windows, the
// window counts, the pair list and the pair count.
int forces_integrate_smem(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols * (16 + 8) +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 + 4;
}

template <bool kRefless>
__global__ void __launch_bounds__(kBlock, kMinBlocks) forces_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const float* __restrict__ ref_x,
    const float* __restrict__ ref_y, const int* __restrict__ occ,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, int disp_lo, int disp_hi,
    bgf::ForceConsts fc, float rho0, float k, bgf::IntegrateConsts ic) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ox[g] = kFar;
      oy[g] = kFar;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
    });
    return;  // the whole block: nothing to add to the displacement max
  }
  // (x, y, vx, vy) and (p, 1/rho): kWinRows x kmax x kWinCols each
  extern __shared__ float4 win[];
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
  float d2 = 0.0f;
  for (int p = threadIdx.x; p < np; p += kBlock) {
    const int c = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = c / kTileCols;
    const int tc = c - tr * kTileCols;
    const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
    const float4 own = win[own_i];
    // b0: window slot (tr, 0, tc), the tap dx = dy = -1
    const float2 a = tile_accel(win, eos, tr * rs + tc, rs,
                                neighbour_counts(cnt, tr, tc).x, own,
                                eos[own_i].x, fc);
    float nx, ny, nvx, nvy;
    const bool live = integrate(own.x, own.y, own.z, own.w, a.x, a.y, ic,
                                nx, ny, nvx, nvy);
    const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
    ox[g] = nx;
    oy[g] = ny;
    ovx[g] = nvx;
    ovy[g] = nvy;
    const int col = t.col0 + tc;
    if (live && col >= disp_lo && col < disp_hi) {
      const float drx = nx - (kRefless ? own.x : ref_x[g]);
      const float dry = ny - (kRefless ? own.y : ref_y[g]);
      d2 = fmaxf(d2, __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)));
    }
  }
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1]) {
      const float4 v = s < kmax ? win[(tr + 1) * rs + s * kWinCols + tc + 1]
                                : make_float4(kFar, kFar, 0.0f, 0.0f);
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ox[g] = v.x;
      oy[g] = v.y;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
    }
  });
  block_max_atomic(d2, disp_bits);
}

}  // namespace

extern "C" int bgf_forces_integrate(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* rho, const float* ref_x, const float* ref_y, const int* occ,
    float* ox, float* oy, float* ovx, float* ovy, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, int refless, int disp_lo,
    int disp_hi, float h, float m_half,
    float spiky_c, float visc_mc, float rho0, float k, float dt, float x_min,
    float x_max, float bounce, float floor_y, cudaStream_t stream) {
  const auto kernel = refless ? forces_integrate_kernel<true>
                              : forces_integrate_kernel<false>;
  const int smem = forces_integrate_smem(cap);
  cudaError_t err = bgf::allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kBlock, smem, stream>>>(
      x, y, vx, vy, rho, ref_x, ref_y, occ, ox, oy, ovx, ovy,
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb, disp_lo,
      disp_hi, bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_forces_integrate_occupancy(int cap, int* out) {
  return bgf::report_occupancy(forces_integrate_kernel<false>, kBlock,
                               forces_integrate_smem(cap), out);
}

// The same for the refless variant.
extern "C" int bgf_forces_integrate_refless_occupancy(int cap, int* out) {
  return bgf::report_occupancy(forces_integrate_kernel<true>, kBlock,
                               forces_integrate_smem(cap), out);
}
