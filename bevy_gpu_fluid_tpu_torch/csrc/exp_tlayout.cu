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
// T2's design: K1's halo tile (bgf_common.cuh) with another staging.  A
// slot layer of the window, kWinRows rows x 32 columns, is one box of a
// plane; each block copies the boxes of its slots below kmax into shared
// memory with cp.async (bgf_async.cuh: 4-byte copies, the window's first
// column being unaligned and wrapped), nothing through registers, then
// counts each window cell's live prefix from shared memory.  The pair
// listing, the thread per live pair and the dead slots' pass are K1's.
// The window keeps the dense kernels' shared layout, window slot (wr, kj,
// wc) at (wr * kmax + kj) * kWinCols + wc, in separate arrays per field.
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

#include "bgf_async.cuh"
#include "bgf_common.cuh"
#include "bgf_tma.cuh"

namespace {

constexpr int kDensityBlock = 128;          // K1's

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
