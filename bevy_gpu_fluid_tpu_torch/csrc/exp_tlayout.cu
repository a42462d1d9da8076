// T2 and T3: K1's density and K8's forces on the SLOT-MAJOR layout: the
// reference's layout experiment.
//
// Replace the TPU kernels `_density_kernel_t` / `density_t` and
// `_forces_kernel_t` / `forces_t` (tools/exp_tlayout.py:37, :182, :187 and
// :84, :158, :165).  The planes are float32 [cap, ny_pad, nx_pad]: element
// (k, row, col) at (k * ny_pad + row) * nx_pad + col, the same cells, rows,
// ghost blocks and FAR sentinel as the dense [ny_pad, cap, nx_pad] planes,
// with the slot axis leading.
//   T2 density: K1's sum, taps in (kj, dx, dy) order, so it is bitwise K1
//      after a movedim; dead slots from the counts, ghost blocks 0, as K1.
//   T3 forces: K8's pair arithmetic (bgf::add_pair_accel), taps in
//      (kj, dy, dx) order, the TPU kernel's (its rolls come after the row
//      slices), so it rounds differently from K8; dead slots and ghost
//      blocks +0, as K8.
//
// What bounds them on the H100: K1's and K8's bytes (3 and 7 planes).  The
// TPU kernel chose the layout for its vector unit (a slot layer is a full
// (8, 128) tile there); on the card a warp reads 32 contiguous floats of one
// (slot, row) in either layout, so the layout moves the rows of one slot
// together and nothing else.
//
// Design: K1's and K8's halo tile (bgf_common.cuh) with another staging.
// A slot layer of the window, kWinRows rows x 32 columns, is one box of a
// plane; each block copies the boxes of its slots below kmax into shared
// memory with cp.async (bgf_async.cuh: 4-byte copies, the window's first
// column being unaligned and wrapped), nothing through registers, then
// counts each window cell's live prefix from shared memory and, for T3,
// turns the staged rho into (p, 1/rho) in place with the twin's float
// operations.  The pair listing, the thread per live pair and the dead
// slots' pass are K1's and K8's.  The window keeps the dense kernels'
// shared layout, window slot (wr, kj, wc) at (wr * kmax + kj) * kWinCols +
// wc, in separate arrays per field.

#include "bgf_async.cuh"
#include "bgf_common.cuh"

namespace {

constexpr int kDensityBlock = 128;          // K1's
constexpr int kForcesBlock = bgf::kThreads;  // K8's

// Offset of the tile's output slot (tr, s, tc) in a slot-major plane.
__device__ __forceinline__ long long out_offset(const bgf::Tile& t, int tr,
                                                int s, int tc, int ny_pad,
                                                int nx_pad) {
  return (static_cast<long long>(s) * ny_pad + t.row0 + tr) * nx_pad +
         t.col0 + tc;
}

// Copies the window slots kj < kmax of kPlanes slot-major planes into
// dst[p] with cp.async, box by box (slot layer kj: window rows wr, columns
// wc, 32 floats a row), fill[p] past the tile's ring; waits for the copies
// and syncs the block.
template <int kBlock, int kPlanes>
__device__ __forceinline__ void stage_boxes(
    const bgf::Tile& t, int kmax, int ny_pad, int nx_pad,
    const float* const (&src)[kPlanes], float* const (&dst)[kPlanes],
    const float (&fill)[kPlanes]) {
  using namespace bgf;
  const int n = kWinRows * kmax * kWinCols;
  for (int e = threadIdx.x; e < n; e += kBlock) {
    const int wc = e % kWinCols;
    const int q = e / kWinCols;   // = kj * kWinRows + wr: box kj, row wr
    const int kj = q / kWinRows;
    const int wr = q - kj * kWinRows;
    const int i = (wr * kmax + kj) * kWinCols + wc;
    if (wr < t.rows + 2 && wc < t.cols + 2) {
      const long long g =
          (static_cast<long long>(kj) * ny_pad + t.row0 - 1 + wr) * nx_pad +
          wrap_col(t.col0 - 1 + wc, nx_pad);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) cp_async4(dst[p] + i, src[p] + g);
    } else {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) dst[p][i] = fill[p];
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Live prefix of window cell c (wr, wc) = (c / kWinCols, c % kWinCols)
// below kmax, from the staged x.
__device__ __forceinline__ int live_prefix(const float* wx, int c, int kmax) {
  const int wr = c / bgf::kWinCols;
  const int wc = c - wr * bgf::kWinCols;
  int n = 0;
  for (int kj = 0; kj < kmax; ++kj)
    n += n == kj && wx[(wr * kmax + kj) * bgf::kWinCols + wc] < bgf::kHalfFar;
  return n;
}

// Dynamic shared memory of T2: the x and y windows, the window counts, the
// pair list, the dead-slot rho per tile cell and the pair count (K1's).
int density_t_smem(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols * 8 +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 +
         bgf::kTileCells * 4 + 4;
}

__global__ void __launch_bounds__(kDensityBlock)
    density_t_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const int* __restrict__ occ, float* __restrict__ rho,
                     int cap, int ny_pad, int nx_pad, int tb, int nb,
                     float h2, float coeff) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kDensityBlock>(t, cap, [&](int tr, int s, int tc) {
      rho[out_offset(t, tr, s, tc, ny_pad, nx_pad)] = 0.0f;
    });
    return;
  }
  extern __shared__ float smem_d[];
  float* wx = smem_d;  // kWinRows x kmax x kWinCols each
  float* wy = wx + kWinRows * cap * kWinCols;
  int* cnt = reinterpret_cast<int*>(wy + kWinRows * cap * kWinCols);
  int* pairs = cnt + kWinRows * kWinCols;
  float* dead_rho = reinterpret_cast<float*>(pairs + kTileCells * cap);
  int* n_pairs = reinterpret_cast<int*>(dead_rho + kTileCells);

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  stage_boxes<kDensityBlock, 2>(t, kmax, ny_pad, nx_pad, {x, y}, {wx, wy},
                                {kFar, kFar});
  for (int c = threadIdx.x; c < kWinRows * kWinCols; c += kDensityBlock)
    cnt[c] = live_prefix(wx, c, kmax);
  __syncthreads();
  if (threadIdx.x < 32) {
    list_pairs(t, kmax, cnt, pairs, n_pairs);
  } else {
    // K1's dead-slot rho: coeff x (h^6 added n times), n the FAR
    // candidates below kmax
    const float h6 = poly6_term(0.0f, 0.0f, h2);
    for (int c = threadIdx.x - 32; c < kTileCells; c += kDensityBlock - 32) {
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
  for (int p = threadIdx.x; p < np; p += kDensityBlock) {
    const int cell = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = cell / kTileCols;
    const int tc = cell - tr * kTileCols;
    const int own = (tr + 1) * rs + s * kWinCols + tc + 1;
    const float ox = wx[own];
    const float oy = wy[own];
    const int kb = neighbour_counts(cnt, tr, tc).x;
    const int b0 = tr * rs + tc;  // window slot (tr, 0, tc): dx = dy = -1
    float acc = 0.0f;
    for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int j = b0 + dy * rs + kj * kWinCols + dx;
          acc += poly6_term(ox - wx[j], oy - wy[j], h2);
        }
    }
    rho[out_offset(t, tr, s, tc, ny_pad, nx_pad)] = acc * coeff;
  }
  for_tile_slots<kDensityBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1])
      rho[out_offset(t, tr, s, tc, ny_pad, nx_pad)] =
          dead_rho[tr * kTileCols + tc];
  });
}

// Dynamic shared memory of T3: x, y, vx, vy, p and 1/rho windows, the
// window counts, the pair list and the pair count (K8's bytes).
int forces_t_smem(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols * 4 * 6 +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 + 4;
}

__global__ void __launch_bounds__(kForcesBlock) forces_t_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const int* __restrict__ occ,
    float* __restrict__ ax_out, float* __restrict__ ay_out, int cap,
    int ny_pad, int nx_pad, int tb, int nb, bgf::ForceConsts fc, float rho0,
    float k) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kForcesBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = out_offset(t, tr, s, tc, ny_pad, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
    });
    return;
  }
  const int w = kWinRows * cap * kWinCols;
  extern __shared__ float smem_f[];
  float* wx = smem_f;
  float* wy = wx + w;
  float* wvx = wy + w;
  float* wvy = wvx + w;
  float* wp = wvy + w;    // rho as staged, then p
  float* wir = wp + w;    // 1/rho
  int* cnt = reinterpret_cast<int*>(wir + w);
  int* pairs = cnt + kWinRows * kWinCols;
  int* n_pairs = pairs + kTileCells * cap;

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  stage_boxes<kForcesBlock, 5>(t, kmax, ny_pad, nx_pad, {x, y, vx, vy, rho},
                               {wx, wy, wvx, wvy, wp},
                               {kFar, kFar, 0.0f, 0.0f, 0.0f});
  // counts, and the EOS pair of every staged slot (K8's: (0, 0) past the
  // tile's ring)
  for (int c = threadIdx.x; c < kWinRows * kWinCols; c += kForcesBlock) {
    const int wr = c / kWinCols;
    const int wc = c - wr * kWinCols;
    const bool in = wr < t.rows + 2 && wc < t.cols + 2;
    for (int kj = 0; kj < kmax; ++kj) {
      const int i = (wr * kmax + kj) * kWinCols + wc;
      const float rg = wp[i];
      wp[i] = in ? k * fmaxf(rg - rho0, 0.0f) : 0.0f;
      wir[i] = in ? 1.0f / fmaxf(rg, 1.0e-12f) : 0.0f;
    }
    cnt[c] = live_prefix(wx, c, kmax);
  }
  __syncthreads();
  if (threadIdx.x < 32) list_pairs(t, kmax, cnt, pairs, n_pairs);
  __syncthreads();

  const int np = *n_pairs;
  const int rs = kmax * kWinCols;  // window row stride
  for (int p = threadIdx.x; p < np; p += kForcesBlock) {
    const int cell = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = cell / kTileCols;
    const int tc = cell - tr * kTileCols;
    const int own = (tr + 1) * rs + s * kWinCols + tc + 1;
    const float ox = wx[own], oy = wy[own], ovx = wvx[own], ovy = wvy[own];
    const float p_i = wp[own];
    const int kb = neighbour_counts(cnt, tr, tc).x;
    const int b0 = tr * rs + tc;
    float ax = 0.0f;
    float ay = 0.0f;
    for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int j = b0 + dy * rs + kj * kWinCols + dx;
          add_pair_accel(ox - wx[j], oy - wy[j], p_i + wp[j], wir[j],
                         wvx[j] - ovx, wvy[j] - ovy, fc, ax, ay);
        }
    }
    const long long g = out_offset(t, tr, s, tc, ny_pad, nx_pad);
    ax_out[g] = ax;
    ay_out[g] = ay;
  }
  for_tile_slots<kForcesBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1]) {
      const long long g = out_offset(t, tr, s, tc, ny_pad, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
    }
  });
}

}  // namespace

// Slot-major planes [cap, ny_pad, nx_pad]; the arguments of bgf_density.
extern "C" int bgf_density_t(const float* x, const float* y, const int* occ,
                             float* rho, int ny_pad, int cap, int nx_pad,
                             int tb, int nb, float h2, float coeff,
                             cudaStream_t stream) {
  const int smem = density_t_smem(cap);
  const cudaError_t err = bgf::allow_smem(density_t_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  density_t_kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kDensityBlock, smem,
                     stream>>>(x, y, occ, rho, cap, ny_pad, nx_pad, tb, nb,
                               h2, coeff);
  return static_cast<int>(cudaGetLastError());
}

// Slot-major planes [cap, ny_pad, nx_pad]; the arguments of bgf_forces.
extern "C" int bgf_forces_t(const float* x, const float* y, const float* vx,
                            const float* vy, const float* rho, const int* occ,
                            float* ax, float* ay, int ny_pad, int cap,
                            int nx_pad, int tb, int nb, float h, float m_half,
                            float spiky_c, float visc_mc, float rho0, float k,
                            cudaStream_t stream) {
  const int smem = forces_t_smem(cap);
  const cudaError_t err = bgf::allow_smem(forces_t_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forces_t_kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kForcesBlock, smem,
                    stream>>>(x, y, vx, vy, rho, occ, ax, ay, cap, ny_pad,
                              nx_pad, tb, nb,
                              bgf::ForceConsts{h, m_half, spiky_c, visc_mc},
                              rho0, k);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes at slot capacity cap, into out[0..4].
extern "C" int bgf_density_t_occupancy(int cap, int* out) {
  return bgf::report_occupancy(density_t_kernel, kDensityBlock,
                               density_t_smem(cap), out);
}

extern "C" int bgf_forces_t_occupancy(int cap, int* out) {
  return bgf::report_occupancy(forces_t_kernel, kForcesBlock,
                               forces_t_smem(cap), out);
}
