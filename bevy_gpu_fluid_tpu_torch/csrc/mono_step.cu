// K5: one whole Verlet step in one launch ("mono" step): density, EOS,
// forces, semi-implicit Euler, bounce and the skin displacement.
//
// Replaces the TPU kernel `_mono_step_kernel` / `mono_step_pallas`
// (bevy_gpu_fluid_tpu/models/pallas_solver.py:657, :1044), which the
// flagship step runs on grids under 12 row blocks.  Same contract as K1
// followed by K2 (csrc/density.cu, csrc/forces_integrate.cu): outputs x', y',
// vx', vy', rho and the max over live slots of |x' - x_ref|^2; ghost blocks
// FAR/FAR/0/0/0.  The pair arithmetic and the (kj, dx, dy) order are K1's
// and K2's.  Two slot bounds, as the Pallas kernel: the density of the
// block's rows and its one-row halo runs over
//   kmax_d = max(occ[0][r-1], occ[0][r], occ[1][r], occ[2][r], occ[2][r+1])
// (r-1 and r+1 clamped to the grid), the forces over
//   kmax_f = max(occ[0][r], occ[1][r], occ[2][r]).
// kmax_d bounds every cell of rows r*tb + tb - 2 ... (r+2)*tb + 1, the rows
// a density of the block's rows and halo reads.  A dead (FAR) slot sums its
// FAR-FAR "self-pairs" below kmax_d, so rho on dead slots differs from K1's;
// live slots match K1 exactly (extra taps add exact zeros), and dead slots
// never reach a live slot's force (hr = 0).
//
// What bounds it on the H100: at the small grids it serves (under 12 row
// blocks, e.g. [104, 8, 128] for 10k particles) neither bytes (11 planes,
// ~5 MB, 0.0014 ms) nor operations (~0.03 GFLOP) but latency: a chain of
// dependent phases in one block, each short.  The first design (a block
// per row block x 16 columns, all cap layers, a thread walking ~5.6
// density slots and 4 force slots in turn, 89% of them dead, each running
// every tap) took 0.0185 ms, with 88 interior blocks on 132 SMs.
//
// Design: the halo tile of bgf_common.cuh with a two-cell ring (MonoTile:
// kMonoRows x 28 cells; 260 blocks at 10k, 220 of them interior).  A block
// stages (x, y, vx, vy) of its tile and a two-cell ring below kmax_d once,
// coalesced, and counts each window cell's live prefix.  Warp 0 lists the
// live (cell, slot) pairs of the tile and its one-cell ring, warp 1 those
// of the tile, and the other warps derive each tile cell's dead-slot rho
// from the counts (coeff x (h^6 added n times from +0), n = 9 kmax_d - the
// sum of its 9 cells' counts: K1's rule under K5's bound).  A thread per
// ring pair sums its density taps from shared memory up to the largest
// count of its 9 cells and keeps p and 1/rho in shared memory (writing rho
// for the tile's own cells); then a thread per tile pair runs K2's tap loop
// on the staged window (bgf::tile_accel), the Euler step, the bounce and
// the displacement max; a coalesced pass writes the dead slots (x, y as
// they were, from the window or FAR, v = 0, rho from the counts) with no
// load from device memory.  The max is a block reduction and one atomicMax
// on the float bits, as in K2.  Offsets inside the window are 32-bit from
// one 64-bit base per block.  The launch covers the ghost blocks and writes
// their fills.

#include "bgf_common.cuh"

namespace {

constexpr int kMonoRows = 2;  // 2 x 28 measured fastest at 10k
using MonoTile = bgf::HaloTile<kMonoRows, 28, 2>;
constexpr int kBlock = bgf::kThreads;  // 256: block_max_atomic's width
constexpr int kRingRows = MonoTile::kRows + 2;  // tile + one-cell ring
constexpr int kRingCols = MonoTile::kCols + 2;
constexpr int kCells = MonoTile::kRows * MonoTile::kCols;

// Dynamic shared memory: the (x, y, vx, vy) and (p, 1/rho) windows, the
// window counts, the ring's and the tile's pair lists, the dead-slot rho
// per tile cell and the two pair counts.
int mono_smem(int cap) {
  return MonoTile::kWinRows * cap * bgf::kWinCols * (16 + 8) +
         MonoTile::kWinRows * bgf::kWinCols * 4 +
         kRingRows * kRingCols * cap * 4 + kCells * cap * 4 + kCells * 4 +
         8;
}

__global__ void __launch_bounds__(kBlock) mono_step_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ ref_x, const float* __restrict__ ref_y,
    const int* __restrict__ occ, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ ovx, float* __restrict__ ovy,
    float* __restrict__ orho, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, float h2, float coeff, bgf::ForceConsts fc,
    float rho0, float k_eos, bgf::IntegrateConsts ic) {
  using namespace bgf;
  const Tile t = tile_of<MonoTile>(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 2) * cap * nx_pad;
  auto out_at = [&](int tr, int s, int tc) {
    return base + tile_offset<MonoTile>(t, tr, s, tc, cap, nx_pad);
  };
  if (t.rb == 0 || t.rb == nb + 1) {  // ghost block: the empty fills
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = out_at(tr, s, tc);
      ox[g] = kFar;
      oy[g] = kFar;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
      orho[g] = 0.0f;
    });
    return;  // the whole block: nothing to add to the displacement max
  }
  // (x, y, vx, vy) and (p, 1/rho): MonoTile::kWinRows x kmax_d x kWinCols
  extern __shared__ float4 win[];
  float2* eos =
      reinterpret_cast<float2*>(win + MonoTile::kWinRows * cap * kWinCols);
  int* cnt = reinterpret_cast<int*>(eos + MonoTile::kWinRows * cap * kWinCols);
  int* ring_pairs = cnt + MonoTile::kWinRows * kWinCols;
  int* tile_pairs = ring_pairs + kRingRows * kRingCols * cap;
  float* dead_rho = reinterpret_cast<float*>(tile_pairs + kCells * cap);
  int* n_pairs = reinterpret_cast<int*>(dead_rho + kCells);  // ring, tile

  const int r = t.rb - 1;  // interior row block
  const int kmax_f = block_kmax(occ, nb, r);
  const int kmax_d = max(kmax_f, max(occ[max(r - 1, 0)],
                                     occ[2 * nb + min(r + 1, nb - 1)]));
  stage_window<kBlock, MonoTile>(t, kmax_d, cap, nx_pad, cnt,
                                 [&](int i, int off) {
    eos[i] = make_float2(0.0f, 0.0f);  // a FAR slot's: finite, never used
    if (off < 0) {
      win[i] = make_float4(kFar, kFar, 0.0f, 0.0f);
      return kFar;
    }
    const long long g = base + off;
    const float xg = x[g];
    win[i] = make_float4(xg, y[g], vx[g], vy[g]);
    return xg;
  });
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp == 0) {
    list_region<kRingRows>(t.rows + 2, t.cols + 2, 1, kRingCols, kmax_d,
                           cnt, ring_pairs, n_pairs);
  } else if (warp == 1) {
    list_region<MonoTile::kRows>(t.rows, t.cols, 2, MonoTile::kCols, kmax_d,
                                 cnt, tile_pairs, n_pairs + 1);
  } else {
    // the dead-slot rho of each tile cell: coeff x (h^6 added n times), n
    // the FAR candidates below kmax_d
    const float h6 = poly6_term(0.0f, 0.0f, h2);
    for (int c = threadIdx.x - 64; c < kCells; c += kBlock - 64) {
      const int tr = c / MonoTile::kCols;
      const int tc = c - tr * MonoTile::kCols;
      const int n = 9 * kmax_d - neighbour_counts(cnt, tr + 1, tc + 1).y;
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc += h6;
      dead_rho[c] = acc * coeff;
    }
  }
  __syncthreads();

  const int rs = kmax_d * kWinCols;  // window row stride
  // density, p and 1/rho of the live slots of the tile and its one-cell
  // ring: ring cell (a, b) is window cell (a + 1, b + 1)
  const int n_ring = n_pairs[0];
  for (int p = threadIdx.x; p < n_ring; p += kBlock) {
    const int c = ring_pairs[p] >> 8;
    const int s = ring_pairs[p] & 255;
    const int a = c / kRingCols;
    const int b = c - a * kRingCols;
    const int own_i = (a + 1) * rs + s * kWinCols + b + 1;
    const float4 own = win[own_i];
    const int kb = neighbour_counts(cnt, a, b).x;
    const int b0 = a * rs + b;  // window slot (a, 0, b): dx = dy = -1
    float acc = 0.0f;
    for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4 w = win[b0 + dy * rs + kj * kWinCols + dx];
          acc += poly6_term(own.x - w.x, own.y - w.y, h2);
        }
    }
    const float rho = __fmul_rn(acc, coeff);  // rounded, as K2 reads it
    eos[own_i] = make_float2(k_eos * fmaxf(rho - rho0, 0.0f),
                             1.0f / fmaxf(rho, 1.0e-12f));
    if (a >= 1 && a <= t.rows && b >= 1 && b <= t.cols)
      orho[out_at(a - 1, s, b - 1)] = rho;
  }
  __syncthreads();

  // forces + Euler + bounce + displacement of the tile's live slots: tile
  // cell (tr, tc) is window cell (tr + 2, tc + 2)
  const int n_tile = n_pairs[1];
  float d2 = 0.0f;
  for (int p = threadIdx.x; p < n_tile; p += kBlock) {
    const int c = tile_pairs[p] >> 8;
    const int s = tile_pairs[p] & 255;
    const int tr = c / MonoTile::kCols;
    const int tc = c - tr * MonoTile::kCols;
    const int own_i = (tr + 2) * rs + s * kWinCols + tc + 2;
    const float4 own = win[own_i];
    const long long g = out_at(tr, s, tc);
    const float rx = ref_x[g];  // loaded here: in flight during the taps
    const float ry = ref_y[g];
    const float2 acc = tile_accel(win, eos, (tr + 1) * rs + tc + 1, rs,
                                  neighbour_counts(cnt, tr + 1, tc + 1).x,
                                  own, eos[own_i].x, fc);
    float nx, ny, nvx, nvy;
    const bool live = integrate(own.x, own.y, own.z, own.w, acc.x, acc.y,
                                ic, nx, ny, nvx, nvy);
    ox[g] = nx;
    oy[g] = ny;
    ovx[g] = nvx;
    ovy[g] = nvy;
    if (live) {
      const float drx = nx - rx;
      const float dry = ny - ry;
      d2 = fmaxf(d2, drx * drx + dry * dry);
    }
  }
  // a dead slot keeps x and y, from the window below kmax_d; past it every
  // slot is dead and holds FAR (live slots are a prefix of the cell), so
  // the pass reads nothing from device memory
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 2) * kWinCols + tc + 2]) {
      const long long g = out_at(tr, s, tc);
      const float4 w = s < kmax_d ? win[(tr + 2) * rs + s * kWinCols + tc + 2]
                                  : make_float4(kFar, kFar, 0.0f, 0.0f);
      ox[g] = w.x;
      oy[g] = w.y;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
      orho[g] = dead_rho[tr * MonoTile::kCols + tc];
    }
  });
  block_max_atomic(d2, disp_bits);
}

// An empty kernel on K5's launch shape: what a launch of this many blocks
// costs on the card with no work, the practical floor under K5's time.
__global__ void __launch_bounds__(kBlock) mono_floor_kernel() {}

}  // namespace

extern "C" int bgf_mono_step(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* ref_x, const float* ref_y, const int* occ, float* ox,
    float* oy, float* ovx, float* ovy, float* orho, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, float h, float h2, float coeff,
    float m_half, float spiky_c, float visc_mc, float rho0, float k, float dt,
    float x_min, float x_max, float bounce, float floor_y,
    cudaStream_t stream) {
  const int smem = mono_smem(cap);
  if (ny_pad != (nb + 2) * tb || tb < 2 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bgf::allow_smem(mono_step_kernel, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  mono_step_kernel<<<bgf::tiles_for<MonoTile>(ny_pad, nx_pad, tb), kBlock,
                     smem, stream>>>(
      x, y, vx, vy, ref_x, ref_y, occ, ox, oy, ovx, ovy, orho,
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb, h2, coeff,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_mono_step_occupancy(int cap, int* out) {
  return bgf::report_occupancy(mono_step_kernel, kBlock, mono_smem(cap), out);
}

// The empty kernel on the launch shape K5 takes on [ny_pad, *, nx_pad].
extern "C" int bgf_mono_floor(int ny_pad, int nx_pad, int tb,
                              cudaStream_t stream) {
  mono_floor_kernel<<<bgf::tiles_for<MonoTile>(ny_pad, nx_pad, tb), kBlock,
                      0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
