// K1: SPH density over the dense slot grid.
//
// Replaces the TPU kernel `_density_kernel` / `density_pallas`
// (bevy_gpu_fluid_tpu/models/pallas_solver.py:224, :854).  Per slot:
//   rho_i = coeff * sum_j max(h^2 - r_ij^2, 0)^3,  coeff = m * 4 / (pi h^8)
// over the 3x3 neighbour cells x kmax slots, kj outer, then dx, then dy --
// the Pallas kernel's order, so the sum runs in the same order as the
// PyTorch twin (models/cuda_solver.density_torch).
//
// What bounds it on the H100.  The bytes bound is one read of x and y and
// one write of rho: 43 MB at the 1M-particle shapes [696, 8, 640], 0.013
// ms at 3.35 TB/s.  A thread per slot over the whole plane took 0.102 ms:
// 72% of the slots are dead at 1M and every slot ran all 9 x kmax taps,
// most of them on FAR candidates that add exactly 0.  The tiled kernel
// runs ~0.029 ms (H100 80GB HBM3, 700 W; PERF.md): with its taps removed
// it still takes ~0.015 ms, its memory phases (staging, the plane write)
// at about a plain plane copy's rate, and its 36M taps (9 x the largest
// neighbour count per live slot) overlap them only in part, at 12 blocks
// of 128 threads per SM (shared memory binds).
//
// Design: the halo tile of bgf_common.cuh.  A block stages its window's x
// and y in shared memory once (coalesced along nx_pad, columns wrapped) and
// counts each window cell's live prefix; warp 0 lists the tile's live
// (cell, slot) pairs while the other warps derive each tile cell's
// dead-slot rho.  A thread per live pair sums its taps from shared memory
// in (kj, dx, dy) order, up to the largest count of its 9 cells: a
// candidate past its own cell's count holds FAR and adds exactly +0, so
// the sum is the twin's term for term (skipping those taps one by one
// measured slower: the branch costs more than the taps it saves).  A dead
// slot (x = y = FAR) sees +0 from every live candidate and h^6 from every
// FAR one, so its rho is coeff x (h^6 added n times), n = 9 kmax - the sum
// of its 9 cells' counts: no tap loads, written by a coalesced pass over
// the tile's slots.  Offsets inside the window are 32-bit from one 64-bit
// base per block.  The launch covers the ghost blocks too and writes 0
// there, the fill the forces kernel's halo expects.

#include "bgf_common.cuh"

namespace {

constexpr int kBlock = 128;  // per block (256 measured slower)

// Dynamic shared memory: the (x, y) window, the window counts, the pair
// list, the dead-slot rho per tile cell and the pair count.
int density_smem(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols * 8 +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 +
         bgf::kTileCells * 4 + 4;
}

__global__ void __launch_bounds__(kBlock)
    density_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int* __restrict__ occ, float* __restrict__ rho,
                   int cap, int nx_pad, int tb, int nb, float h2,
                   float coeff) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      rho[base + tile_offset(t, tr, s, tc, cap, nx_pad)] = 0.0f;
    });
    return;
  }
  extern __shared__ float2 win[];  // kWinRows x kmax x kWinCols
  int* cnt = reinterpret_cast<int*>(win + kWinRows * cap * kWinCols);
  int* pairs = cnt + kWinRows * kWinCols;
  float* dead_rho = reinterpret_cast<float*>(pairs + kTileCells * cap);
  int* n_pairs = reinterpret_cast<int*>(dead_rho + kTileCells);

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  const float* xb = x + base;
  const float* yb = y + base;
  float* out = rho + base;
  stage_window<kBlock>(t, kmax, cap, nx_pad, cnt, [&](int i, int off) {
    const float2 v =
        off < 0 ? make_float2(kFar, kFar) : make_float2(xb[off], yb[off]);
    win[i] = v;
    return v.x;
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    list_pairs(t, kmax, cnt, pairs, n_pairs);
  } else {
    // the dead-slot rho of each tile cell, on the warps the listing leaves
    // idle: coeff x (h^6 added n times), n the FAR candidates below kmax
    const float h6 = poly6_term(0.0f, 0.0f, h2);
    for (int c = threadIdx.x - 32; c < kTileCells; c += kBlock - 32) {
      const int tr = c / kTileCols;
      const int n = 9 * kmax - neighbour_counts(cnt, tr, c - tr * kTileCols).y;
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc += h6;
      dead_rho[c] = acc * coeff;
    }
  }
  __syncthreads();

  const int np = *n_pairs;
  const int rs = kmax * kWinCols;  // window row stride
  for (int p = threadIdx.x; p < np; p += kBlock) {
    const int c = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = c / kTileCols;
    const int tc = c - tr * kTileCols;
    const float2 own = win[(tr + 1) * rs + s * kWinCols + tc + 1];
    const int kb = neighbour_counts(cnt, tr, tc).x;
    const int b0 = tr * rs + tc;  // window slot (tr, 0, tc): dx = dy = -1
    float acc = 0.0f;
    for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float2 w = win[b0 + dy * rs + kj * kWinCols + dx];
          acc += poly6_term(own.x - w.x, own.y - w.y, h2);
        }
    }
    out[tile_offset(t, tr, s, tc, cap, nx_pad)] = acc * coeff;
  }
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1])
      out[tile_offset(t, tr, s, tc, cap, nx_pad)] =
          dead_rho[tr * kTileCols + tc];
  });
}

}  // namespace

extern "C" int bgf_density(const float* x, const float* y, const int* occ,
                           float* rho, int ny_pad, int cap, int nx_pad,
                           int tb, int nb, float h2, float coeff,
                           cudaStream_t stream) {
  const int smem = density_smem(cap);
  const cudaError_t err = bgf::allow_smem(density_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  density_kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kBlock, smem,
                   stream>>>(x, y, occ, rho, cap, nx_pad, tb, nb, h2, coeff);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_density_occupancy(int cap, int* out) {
  return bgf::report_occupancy(density_kernel, kBlock, density_smem(cap),
                              out);
}
