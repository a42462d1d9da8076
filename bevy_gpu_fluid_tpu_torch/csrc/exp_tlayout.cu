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
// T2's design: the walk tile of bgf_walk.cuh.  Its first form (K1's halo
// tile, one 4-byte cp.async per element from an unaligned window, then a
// second pass over shared memory for the counts) ran 1.28x K1.  Now 4 x
// 28-cell tiles from column 1 (bgf::ring_tile), so a window row of one
// slot layer, a row of the plane's slot layer kj, is eight aligned 16-byte
// chunks: a warp per window row, its lanes four slot layers of the eight
// chunks at a time, loads x and y as float4s, stores them as (x, y) pairs
// into the column-major window and counts each column's live prefix in
// the same pass.  Warp 0 lists the items (cell, slot pair) while the other
// warps derive each tile cell's dead-slot rho from the counts (K1's: coeff
// x (h^6 added n times), n the FAR candidates below kmax), plane column 0
// included (its left neighbour, the last column, is a ghost column: count
// 0); a thread per item taps K1's candidates (every one below the largest
// of its cell's 9 counts, in (kj, dx, dy) order), each loaded once for
// both slots' sums, so rho is K1's bit for bit.  128 threads a block, as
// K1.  Timings, occupancy and the designs tried are in PERF.md
// (chip_smoke.py phase 20 and tools/torch_tile_study.py).
//
// T3's design: the TMA stage of bgf_tma.cuh, as T1's (exp_dbuf.cu).  One
// tensor map per input plane (x, y, vx, vy, rho), dims {nx_pad, ny_pad,
// cap}; a tile is 2 x 28 cells from column 1 on (bgf::ring_tile: its
// window's first column is 16-byte aligned, as a box's must be), a field's
// window a box {32, rows + 2, 1} per slot below the tile's kmax at
// (col0 - 1, row0 - 1, slot), so a slot layer of the window is a rectangle
// of the plane, TMA's best case.  A producer warp's first lane arms the
// stage's full barrier with the tile's bytes and issues its boxes once the
// consumers have released the stage (its empty barrier).
// The consumer warps repack the landed fields into K8's packed window
// (bgf::repack_force_window: (x, y, vx, vy) and the EOS pair (p, 1/rho),
// FAR past the plane's last column, which K8 wraps to a ghost column, and
// the counts), release the stage, list the live pairs, tap in (kj, dy, dx)
// order two shared loads a tap and write the dead slots +0; ghost column
// 0, in no tile, gets its zeros with the ghost blocks'.  Six consumer
// warps and one producer, four blocks per SM (28 resident warps), walking
// the interior tiles persistently (blocks per SM x SMs blocks; a block per
// tile measured the same).

#include "bgf_walk.cuh"

namespace {

using DensityTile = bgf::WalkTile<4, 7>;  // tile rows, window stride
constexpr int kDensityBlock = 128;          // K1's
constexpr int kDensitySlots = 2;   // slots a thread (1: K1's thread per slot)

// Offset of the tile's output slot (tr, s, tc) in a slot-major plane.
__device__ __forceinline__ long long out_offset(const bgf::Tile& t, int tr,
                                                int s, int tc, int ny_pad,
                                                int nx_pad) {
  return (static_cast<long long>(s) * ny_pad + t.row0 + tr) * nx_pad +
         t.col0 + tc;
}

// Dynamic shared memory of T2: the (x, y) window at cap slot layers, the
// window counts, the dead-slot rho per tile row and window column, the
// items and their count (models/exp_kernels.walk_plan mirrors it).
int density_t_smem(int cap) {
  using G = DensityTile;
  return G::win_slots(cap) * 8 + G::kWinRows * bgf::kWinCols * 4 +
         G::kRows * bgf::kWinCols * 4 +
         bgf::item_slots<G, kDensitySlots>(cap) * 2 + 4;
}

__global__ void __launch_bounds__(kDensityBlock)
    density_t_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const int* __restrict__ occ, float* __restrict__ rho,
                     int cap, int ny_pad, int nx_pad, int tb, int nb,
                     float h2, float coeff) {
  using namespace bgf;
  using G = DensityTile;
  const Tile t = ring_tile(blockIdx.x, nx_pad, tb, G::kRows);
  // window column wc of the tile is plane column col0 - 1 + wc
  const auto out_at = [&](int tr, int s, int wc) {
    return out_offset(t, tr, s, wc - 1, ny_pad, nx_pad);
  };
  if (t.rb == 0 || t.rb == nb + 1) {
    for_walk_slots<kDensityBlock>(t, cap, [&](int tr, int s, int wc) {
      rho[out_at(tr, s, wc)] = 0.0f;
    });
    return;
  }
  extern __shared__ float2 smem_d[];
  float2* win = smem_d;  // G::kLayer x cap, column-major
  int* cnt = reinterpret_cast<int*>(win + G::win_slots(cap));
  float* dead_rho = reinterpret_cast<float*>(cnt + G::kWinRows * kWinCols);
  unsigned short* items =
      reinterpret_cast<unsigned short*>(dead_rho + G::kRows * kWinCols);
  int* n_items =
      reinterpret_cast<int*>(items + item_slots<G, kDensitySlots>(cap));

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  stage_chunks<kDensityBlock, G>(t, kmax, nx_pad, cnt,
                                 [&](int kj, int wr, int q, bool in) {
    float4 xv = make_float4(kFar, kFar, kFar, kFar), yv = xv;
    if (in) {
      const long long g =
          (static_cast<long long>(kj) * ny_pad + t.row0 - 1 + wr) * nx_pad +
          t.col0 - 1 + 4 * q;
      xv = *reinterpret_cast<const float4*>(x + g);
      yv = *reinterpret_cast<const float4*>(y + g);
    }
    const int j = G::at(kj, 4 * q, wr);
    win[j] = make_float2(xv.x, yv.x);
    win[j + G::kR] = make_float2(xv.y, yv.y);
    win[j + 2 * G::kR] = make_float2(xv.z, yv.z);
    win[j + 3 * G::kR] = make_float2(xv.w, yv.w);
    return xv;
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    list_items<G::kRows, kDensitySlots>(t, kmax, cnt, items, n_items);
  } else {
    // K1's dead-slot rho of each tile cell, and of plane column 0 in the
    // first tile (window column 0): coeff x (h^6 added n times), n the
    // FAR candidates below kmax
    const float h6 = poly6_term(0.0f, 0.0f, h2);
    const int wc0 = t.col0 == 1 ? 0 : 1;
    const int cols = t.cols + 1 - wc0;
    for (int c = threadIdx.x - 32; c < t.rows * cols;
         c += kDensityBlock - 32) {
      const int tr = c / cols;
      const int wc = wc0 + c - tr * cols;
      int live = 0;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = wc == 0 ? 1 : 0; dx < 3; ++dx)
          live += cnt[(tr + dy) * kWinCols + wc - 1 + dx];
      const int n = 9 * kmax - live;
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc += h6;
      dead_rho[tr * kWinCols + wc] = acc * coeff;
    }
  }
  __syncthreads();

  const int n = *n_items;
  for (int p = threadIdx.x; p < n; p += kDensityBlock) {
    const int cell = items[p] >> 6;
    const int s = items[p] & 63;
    const int tr = cell / kRingCols;
    const int tc = cell - tr * kRingCols;
    const int i0 = G::at(s, tc + 1, tr + 1);
    // the second slot when it is live, else a copy of the first (summed,
    // never written)
    const bool two =
        kDensitySlots == 2 && s + 1 < cnt[(tr + 1) * kWinCols + tc + 1];
    const float2 own0 = win[i0];
    const float2 own1 = win[two ? i0 + G::kLayer : i0];
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    walk_taps<G::kLayer, G::kR>(
        cnt, tr, tc, G::at(0, tc, tr), [&](int j) {
          const float2 w = win[j];
          acc0 += poly6_term(own0.x - w.x, own0.y - w.y, h2);
          if (kDensitySlots == 2)
            acc1 += poly6_term(own1.x - w.x, own1.y - w.y, h2);
        });
    const long long g = out_at(tr, s, tc + 1);
    rho[g] = acc0 * coeff;
    if (two) rho[g + static_cast<long long>(ny_pad) * nx_pad] = acc1 * coeff;
  }
  // dead slots, and plane column 0 (a ghost column: all its slots dead)
  for_walk_slots<kDensityBlock>(t, cap, [&](int tr, int s, int wc) {
    if (wc == 0 || s >= cnt[(tr + 1) * kWinCols + wc])
      rho[out_at(tr, s, wc)] = dead_rho[tr * kWinCols + wc];
  });
}

// ---- T3: the TMA stage on slot-major planes

constexpr int kRows = 2;            // tile rows (x bgf::kRingCols columns)
constexpr int kW = kRows + 2;       // window rows
constexpr int kWarps = 6;           // consumer warps (+ one producer warp)
constexpr int kCons = 32 * kWarps;  // consumer threads
constexpr int kForceThreads = kCons + 32;
constexpr int kMinBlocks = 4;       // blocks per SM it is built for
constexpr int kForceFields = 5;     // x, y, vx, vy, rho
static_assert(kWarps <= bgf::kMaxWarps, "a warp maximum per consumer warp");

struct ForceMaps {
  CUtensorMap win[kForceFields];
};

// Floats of one window field at cap slots.
__host__ __device__ __forceinline__ int window_floats(int cap) {
  return kW * cap * bgf::kWinCols;
}

// Dynamic shared memory of T3: the stage of five window fields, then the
// packed (x, y, vx, vy) and (p, 1/rho) windows, the counts, the pair list
// and its count (models/exp_kernels.forces_t_plan mirrors it).
int forces_t_smem(int cap) {
  const int win = window_floats(cap);
  return bgf::stage_smem_bytes(
      kForceFields * win * 4,
      win * (16 + 8) + kW * bgf::kWinCols * 4 +
          (kRows * bgf::kRingCols * cap + 1) * 4);
}

__global__ void __launch_bounds__(kForceThreads, kMinBlocks)
    forces_t_kernel(__grid_constant__ const ForceMaps maps,
                    const int* __restrict__ occ, float* __restrict__ ax_out,
                    float* __restrict__ ay_out, int cap, int ny_pad,
                    int nx_pad, int tb, int nb, bgf::ForceConsts fc,
                    float rho0, float k) {
  using namespace bgf;
  // a landed field's slot (wr, kj, wc) at (kj * kW + wr) * 32 + wc: a box
  // per slot, a slot layer of the window a rectangle of the plane
  const int win = window_floats(cap);
  extern __shared__ unsigned char smem_t[];
  const StageSmem sm = stage_smem(smem_t, kForceFields * win);
  stage_init(sm);

  const int per_rb = ((tb + kRows - 1) / kRows) * ring_tiles_x(nx_pad);
  const int n_tiles = nb * per_rb;  // interior tiles, from row block 1 on

  if (threadIdx.x >= kCons) {  // the producer warp
    if (threadIdx.x != kCons) return;
    for (int f = 0; f < kForceFields; ++f) prefetch_tensormap(&maps.win[f]);
    constexpr uint32_t kSlotBytes = kForceFields * kW * kWinCols * 4;
    int i = 0;
    for (int b = blockIdx.x; b < n_tiles; b += gridDim.x, ++i) {
      mbar_wait(sm.empty, (i & 1) ^ 1);
      const Tile t = ring_tile(b + per_rb, nx_pad, tb, kRows);
      const int kmax = block_kmax(occ, nb, t.rb - 1);
      mbar_arrive_expect_tx(sm.full, kmax * kSlotBytes);
      for (int j = 0; j < kmax; ++j)
        for (int f = 0; f < kForceFields; ++f)
          tma_load_3d(sm.stage + f * win + j * kW * kWinCols, &maps.win[f],
                      sm.full, t.col0 - 1, t.row0 - 1, j);
    }
    return;
  }

  float4* pwin = reinterpret_cast<float4*>(sm.tail);
  float2* eos = reinterpret_cast<float2*>(pwin + win);
  int* cnt = reinterpret_cast<int*>(eos + win);
  int* pairs = cnt + kW * kWinCols;
  int* n_pairs = pairs + kRows * kRingCols * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // zeros, as K8, in the ghost blocks and in ghost column 0 (in no tile;
  // its slots are dead)
  const long long ghost = 2LL * tb * nx_pad;  // a slot's ghost elements
  const long long n_col0 = static_cast<long long>(nb) * tb;  // a slot's
  for (long long e = static_cast<long long>(blockIdx.x) * kCons + threadIdx.x;
       e < (ghost + n_col0) * cap;
       e += static_cast<long long>(gridDim.x) * kCons) {
    long long g;
    if (e < ghost * cap) {
      const long long s = e / ghost;
      const long long r = e - s * ghost;
      g = s * ny_pad * nx_pad +
          (r < tb * nx_pad ? r : r + static_cast<long long>(nb) * tb * nx_pad);
    } else {
      const long long q = e - ghost * cap;
      const long long s = q / n_col0;
      g = (s * ny_pad + tb + q - s * n_col0) * nx_pad;
    }
    ax_out[g] = 0.0f;
    ay_out[g] = 0.0f;
  }

  int i = 0;
  for (int b = blockIdx.x; b < n_tiles; b += gridDim.x, ++i) {
    const Tile t = ring_tile(b + per_rb, nx_pad, tb, kRows);
    const int kmax = block_kmax(occ, nb, t.rb - 1);
    mbar_wait(sm.full, i & 1);
    repack_force_window<kCons, kW>(t, kmax, nx_pad, sm.stage, win, rho0, k,
                                   pwin, eos, cnt);
    consumer_sync(kCons);  // the stage is read: the producer may refill it
    if (threadIdx.x == 0) mbar_arrive(sm.empty);
    if (warp == 0)
      list_region<kRows>(t.rows, t.cols, 1, kRingCols, kmax, cnt, pairs,
                         n_pairs);
    consumer_sync(kCons);

    const int np = *n_pairs;
    const int rs = kmax * kWinCols;  // window row stride
    for (int p = threadIdx.x; p < np; p += kCons) {
      const int cell = pairs[p] >> 8;
      const int s = pairs[p] & 255;
      const int tr = cell / kRingCols;
      const int tc = cell - tr * kRingCols;
      const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
      const float4 own = pwin[own_i];
      const float p_i = eos[own_i].x;
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
            const float4 w = pwin[j];
            const float2 e = eos[j];
            add_pair_accel(own.x - w.x, own.y - w.y, p_i + e.x, e.y,
                           w.z - own.z, w.w - own.w, fc, ax, ay);
          }
      }
      const long long g = out_offset(t, tr, s, tc, ny_pad, nx_pad);
      ax_out[g] = ax;
      ay_out[g] = ay;
    }
    if (lane < t.cols)
      for (int tr = 0; tr < t.rows; ++tr)
        for (int s = warp; s < cap; s += kWarps)
          if (s >= cnt[(tr + 1) * kWinCols + lane + 1]) {
            const long long g = out_offset(t, tr, s, lane, ny_pad, nx_pad);
            ax_out[g] = 0.0f;
            ay_out[g] = 0.0f;
          }
    consumer_sync(kCons);  // the window and the lists are read
  }
}

}  // namespace

// Slot-major planes [cap, ny_pad, nx_pad], 16-byte aligned, nx_pad a
// multiple of 4, cap <= bgf::kMaxCap (the wrapper checks them;
// cudaErrorInvalidValue here otherwise); the arguments of bgf_density.
extern "C" int bgf_density_t(const float* x, const float* y, const int* occ,
                             float* rho, int ny_pad, int cap, int nx_pad,
                             int tb, int nb, float h2, float coeff,
                             cudaStream_t stream) {
  if (cap > bgf::kMaxCap || nx_pad % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = density_t_smem(cap);
  const cudaError_t err = bgf::allow_smem(density_t_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  density_t_kernel<<<bgf::walk_tiles(ny_pad, nx_pad, tb, DensityTile::kRows),
                     kDensityBlock, smem, stream>>>(
      x, y, occ, rho, cap, ny_pad, nx_pad, tb, nb, h2, coeff);
  return static_cast<int>(cudaGetLastError());
}

// Slot-major planes [cap, ny_pad, nx_pad]; the arguments of bgf_forces.
// Returns 0, a cudaError_t, or bgf::kEncodeError + the driver's CUresult
// when a tensor map was refused.
extern "C" int bgf_forces_t(const float* x, const float* y, const float* vx,
                            const float* vy, const float* rho, const int* occ,
                            float* ax, float* ay, int ny_pad, int cap,
                            int nx_pad, int tb, int nb, float h, float m_half,
                            float spiky_c, float visc_mc, float rho0, float k,
                            cudaStream_t stream) {
  const int smem = forces_t_smem(cap);
  unsigned blocks = 0;
  cudaError_t err =
      bgf::check_blocks(forces_t_kernel, kForceThreads, smem, kMinBlocks);
  if (err == cudaSuccess)
    err = bgf::persistent_grid(
        kMinBlocks,
        static_cast<long long>(nb) * ((tb + kRows - 1) / kRows) *
            bgf::ring_tiles_x(nx_pad),
        &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each plane [cap, ny_pad, nx_pad] as dims {nx_pad, ny_pad, cap}
  const long long dims[3] = {nx_pad, ny_pad, cap};
  const long long strides[2] = {4LL * nx_pad, 4LL * ny_pad * nx_pad};
  const int box[3] = {bgf::kWinCols, kW, 1};
  ForceMaps maps;
  const float* src[kForceFields] = {x, y, vx, vy, rho};
  for (int f = 0; f < kForceFields; ++f) {
    const int e = bgf::encode_map_3d(&maps.win[f], src[f], dims, strides, box);
    if (e != 0) return e;
  }
  forces_t_kernel<<<blocks, kForceThreads, smem, stream>>>(
      maps, occ, ax, ay, cap, ny_pad, nx_pad, tb, nb,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes at slot capacity cap, into out[0..4].
extern "C" int bgf_density_t_occupancy(int cap, int* out) {
  return bgf::report_occupancy(density_t_kernel, kDensityBlock,
                               density_t_smem(cap), out);
}

extern "C" int bgf_forces_t_occupancy(int cap, int* out) {
  return bgf::report_occupancy(forces_t_kernel, kForceThreads,
                               forces_t_smem(cap), out);
}
