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

constexpr int kThreads = 256;       // threads per block (K1 uses 128)
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

// ---- the rebin's candidate scan, shared by K3 (reslot) and K6 (select) so
// that both assign slots with the same arithmetic, bit for bit.

// The cell arithmetic of a rebin: x cells clipped to [clip_lo, clip_hi] (the
// single-chip [0, nx-1]; a slab of the sharded solver widens it to [-1, nx],
// so a particle that left the slab is captured in a ghost column), y cells
// to [0, ny-1], from the world origin of the grid or of the slab.
struct CellGrid {
  int ny, row0, clip_lo, clip_hi;
  float origin_x, origin_y, inv;
};

// clip(floor((v - origin) * inv), lo, hi), rounded as the PyTorch twins
// round it (no FMA contraction: ops/binning.cell_index).
__device__ __forceinline__ int cell_of(float v, float origin, float inv,
                                       int lo, int hi) {
  const float c = floorf(__fmul_rn(__fsub_rn(v, origin), inv));
  return static_cast<int>(
      fminf(fmaxf(c, static_cast<float>(lo)), static_cast<float>(hi)));
}

// Routing code of candidate (kj, dx, dy): kj * 9 + (dx + 1) * 3 + (dy + 1),
// the TPU kernels' `_code_of` (-1 = empty).
__device__ __forceinline__ int code_of(int kj, int dx, int dy) {
  return kj * 9 + (dx + 1) * 3 + (dy + 1);
}

// Scans the 3x3 x kmax candidate slots of target cell (row, col) in
// (kj, dx, dy) order; a candidate matches when it is live (x < FAR/2) and
// its clipped cell is the target.  Calls on_match(rank, j, code) for the
// first cap matches (j the candidate's flat index) and returns the match
// count, which may exceed cap.
template <class OnMatch>
__device__ __forceinline__ int scan_candidates(
    const float* __restrict__ x, const float* __restrict__ y, int row,
    int col, int kmax, int cap, int nx_pad, const CellGrid& g,
    OnMatch on_match) {
  const int tgt_cx = col - 1;
  const int tgt_cy = row - g.row0;
  int count = 0;
  for (int kj = 0; kj < kmax; ++kj) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int c = wrap_col(col + dx, nx_pad);
      for (int dy = -1; dy <= 1; ++dy) {
        const long long j =
            (static_cast<long long>(row + dy) * cap + kj) * nx_pad + c;
        const float cx = x[j];
        if (!(cx < kHalfFar)) continue;
        const float cy = y[j];
        if (cell_of(cx, g.origin_x, g.inv, g.clip_lo, g.clip_hi) != tgt_cx ||
            cell_of(cy, g.origin_y, g.inv, 0, g.ny - 1) != tgt_cy)
          continue;
        if (count < cap) on_match(count, j, code_of(kj, dx, dy));
        ++count;
      }
    }
  }
  return count;
}

// ---- the halo tile of K1 (density), K2 (forces + integrate), K8 (forces),
// K5 (the mono step), K4 (field raster) and K6 (select).
//
// A block owns G::kRows cell rows x G::kCols cell columns of one row block,
// with all cap slot layers; one slot bound kmax (block_kmax, or K5's
// kmax_d) covers it.  For K1, K2 and K8 (the default geometry, StencilTile)
// 4 x 30 measured fastest for K1 and K2 at 1M on the H100 (against 2 x 30
// and 8 x 30), with 128 threads per block for K1 and 256 for K2 (each
// kernel's kBlock; 384 and 512 were slower).  Its window, the tile and a
// ring of G::kRing cells, is staged in shared memory once: window slot
// (wr, kj, wc), wr < G::kWinRows, kj < kmax, wc < kWinCols, sits at (wr *
// kmax + kj) * kWinCols + wc and holds the plane element (row0 - kRing +
// wr, kj, wrap_col(col0 - kRing + wc)).  Every geometry's window is 32
// columns wide, one lane per column.  Live slots are a prefix of each
// cell's slots (binning ranks from 0, K3 writes rank k at slot k, the
// spill re-admit continues from the cell's occupancy), so a cell's count
// is its first slot at or past FAR/2, and every slot past it holds FAR.
// The kernels take occ as the sim's block_kmax3, which bounds every cell of
// the rows a block reads, so no live slot lies at or past kmax.

constexpr int kWinCols = 32;   // one warp stages a window row

template <int kRows_, int kCols_, int kRing_>
struct HaloTile {
  static constexpr int kRows = kRows_;
  static constexpr int kCols = kCols_;
  static constexpr int kRing = kRing_;
  static constexpr int kWinRows = kRows + 2 * kRing;
  static_assert(kCols + 2 * kRing == kWinCols, "a lane per window column");
};

constexpr int kTileRows = 4;
constexpr int kTileCols = 30;
using StencilTile = HaloTile<kTileRows, kTileCols, 1>;   // K1, K2, K8
constexpr int kWinRows = StencilTile::kWinRows;
constexpr int kTileCells = kTileRows * kTileCols;

struct Tile {
  int row0, rows;  // first output row; rows owned (fewer at a row block end)
  int col0, cols;  // first output column; columns owned (fewer at the right)
  int rb;          // row block over all ny_pad rows: 0 and nb + 1 are ghosts
};

// Blocks of a tiled launch over [ny_pad, cap, nx_pad] (host side).
template <class G = StencilTile>
inline unsigned tiles_for(int ny_pad, int nx_pad, int tb) {
  return static_cast<unsigned>(
      (ny_pad / tb) * ((tb + G::kRows - 1) / G::kRows) *
      ((nx_pad + G::kCols - 1) / G::kCols));
}

// Tile b of the launch (row-block major, then tile row, then tile column):
// a tiled kernel's block blockIdx.x; a persistent kernel's tile b.
template <class G = StencilTile>
__device__ __forceinline__ Tile tile_at(int b, int nx_pad, int tb) {
  const int tiles_x = (nx_pad + G::kCols - 1) / G::kCols;
  const int per_rb = (tb + G::kRows - 1) / G::kRows;
  const int ty = b / tiles_x;
  Tile t;
  t.col0 = (b - ty * tiles_x) * G::kCols;
  t.cols = min(G::kCols, nx_pad - t.col0);
  t.rb = ty / per_rb;
  const int r_in = (ty - t.rb * per_rb) * G::kRows;
  t.row0 = t.rb * tb + r_in;
  t.rows = min(G::kRows, tb - r_in);
  return t;
}

template <class G = StencilTile>
__device__ __forceinline__ Tile tile_of(int nx_pad, int tb) {
  return tile_at<G>(blockIdx.x, nx_pad, tb);
}

// Offset of the tile's output slot (tr, s, tc) from the window's first row.
template <class G = StencilTile>
__device__ __forceinline__ int tile_offset(const Tile& t, int tr, int s,
                                           int tc, int cap, int nx_pad) {
  return ((tr + G::kRing) * cap + s) * nx_pad + t.col0 + tc;
}

// Stages the window and counts each window cell's live slots below kmax
// into cnt[wr * kWinCols + wc].  Thread c < G::kWinRows * kWinCols takes
// window cell (wr, wc) = (c / kWinCols, c % kWinCols), so a warp reads a
// window row coalesced, and walks its slots kj < kmax, calling stage(i,
// off) with the window slot index i and the plane offset off from the
// window's first row, or -1 past the tile's ring (a ragged tile's unused
// columns, a short tile's unused rows), where it stages FAR.  stage returns
// the slot's x.  kBlock is the kernel's block size.
template <int kBlock, class G = StencilTile, class Stage>
__device__ __forceinline__ void stage_window(const Tile& t, int kmax,
                                             int cap, int nx_pad, int* cnt,
                                             Stage stage) {
  for (int c = threadIdx.x; c < G::kWinRows * kWinCols; c += kBlock) {
    const int wr = c / kWinCols;
    const int wc = c % kWinCols;
    const bool in = wr < t.rows + 2 * G::kRing && wc < t.cols + 2 * G::kRing;
    const int off =
        wr * cap * nx_pad + wrap_col(t.col0 - G::kRing + wc, nx_pad);
    int n = 0;
#pragma unroll 4
    for (int kj = 0; kj < kmax; ++kj) {
      const float xv = stage((wr * kmax + kj) * kWinCols + wc,
                             in ? off + kj * nx_pad : -1);
      n += n == kj && xv < kHalfFar;
    }
    cnt[c] = n;
  }
}

// The max and the sum of the live counts of the 3x3 window cells whose
// top-left cell is (wr, wc): the neighbours of window cell (wr + 1, wc + 1).
// The max is that cell's own slot bound (<= kmax): a candidate past its
// cell's count holds FAR and adds exactly 0 to a live slot's sums, so the
// taps below the bound give the twin's sums bit for bit.
__device__ __forceinline__ int2 neighbour_counts(const int* cnt, int wr,
                                                 int wc) {
  int2 r = make_int2(0, 0);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int n = cnt[(wr + dy) * kWinCols + wc + dx];
      r.x = max(r.x, n);
      r.y += n;
    }
  return r;
}

// Lists the live (cell, slot) pairs of a region of the window, cells (rr,
// rc) with rr < rows <= kRegRows and rc < cols, at window cell (rr + off,
// rc + off), as cell << 8 | slot with cell = rr * stride + rc, in (row,
// slot, column) order: a warp's lanes take neighbouring cells at one slot,
// so their stores are coalesced; and their number into *n_pairs.  One warp
// (a lane per column, a ballot per row and slot), once cnt is complete;
// the caller syncs before reading it.
template <int kRegRows>
__device__ __forceinline__ void list_region(int rows, int cols, int off,
                                            int stride, int kmax,
                                            const int* cnt, int* pairs,
                                            int* n_pairs) {
  const int lane = threadIdx.x & 31;
  int n_row[kRegRows];
#pragma unroll
  for (int rr = 0; rr < kRegRows; ++rr)
    n_row[rr] = rr < rows && lane < cols
                    ? cnt[(rr + off) * kWinCols + lane + off] : 0;
  int base = 0;
#pragma unroll
  for (int rr = 0; rr < kRegRows; ++rr)
    for (int s = 0; s < kmax; ++s) {
      const bool live = s < n_row[rr];
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live)
        pairs[base + __popc(m & ((1u << lane) - 1u))] =
            (rr * stride + lane) << 8 | s;
      base += __popc(m);
    }
  if (lane == 0) *n_pairs = base;
}

// The tile's live pairs of K1, K2 and K8 (cell = tr * kTileCols + tc).
// Warp 0 only.
__device__ __forceinline__ void list_pairs(const Tile& t, int kmax,
                                           const int* cnt, int* pairs,
                                           int* n_pairs) {
  list_region<kTileRows>(t.rows, t.cols, 1, kTileCols, kmax, cnt, pairs,
                         n_pairs);
}

// The force window of K2 and K8: stages (x, y, vx, vy) into win and the
// EOS pair (p, 1/rho) into eos, taken once per staged slot with the twin's
// float operations (p = k max(rho - rho0, 0), 1/max(rho, 1e-12)), so they
// are the bits the twin uses; FAR and zeros past the tile's ring.  base is
// the plane offset of the window's first row.
template <int kBlock>
__device__ __forceinline__ void stage_force_window(
    const Tile& t, int kmax, int cap, int nx_pad, long long base,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, float rho0, float k, float4* win,
    float2* eos, int* cnt) {
  stage_window<kBlock>(t, kmax, cap, nx_pad, cnt, [&](int i, int off) {
    if (off < 0) {
      win[i] = make_float4(kFar, kFar, 0.0f, 0.0f);
      eos[i] = make_float2(0.0f, 0.0f);
      return kFar;
    }
    const long long g = base + off;
    const float xg = x[g];
    const float rg = rho[g];
    win[i] = make_float4(xg, y[g], vx[g], vy[g]);
    eos[i] = make_float2(k * fmaxf(rg - rho0, 0.0f),
                         1.0f / fmaxf(rg, 1.0e-12f));
    return xg;
  });
}

// The pressure + viscosity acceleration of one live slot (own: its x, y,
// vx, vy; p_i its pressure) from a staged window: the taps at window slots
// b0 + dy * rs + kj * kWinCols + dx, kj < kb, in (kj, dx, dy) order (b0 the
// slot (row - 1, 0, col - 1) of the slot's cell, rs the window row stride).
// A tap on a FAR slot adds +-0, and the sums start at +0, so they never
// hold -0 and equal the twin's, which takes every tap below kmax.
__device__ __forceinline__ float2 tile_accel(const float4* win,
                                             const float2* eos, int b0,
                                             int rs, int kb, float4 own,
                                             float p_i,
                                             const ForceConsts& fc) {
  float ax = 0.0f;
  float ay = 0.0f;
  for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int j = b0 + dy * rs + kj * kWinCols + dx;
        const float4 w = win[j];
        const float2 e = eos[j];
        add_pair_accel(own.x - w.x, own.y - w.y, p_i + e.x, e.y,
                       w.z - own.z, w.w - own.w, fc, ax, ay);
      }
  }
  return make_float2(ax, ay);
}

// Calls fn(tr, s, tc) for every output slot of the tile: a warp per (row,
// slot) layer, a lane per column, so the writes are coalesced.
template <int kBlock, class Fn>
__device__ __forceinline__ void for_tile_slots(const Tile& t, int cap,
                                               Fn fn) {
  const int tc = threadIdx.x % 32;
  if (tc >= t.cols) return;
  for (int tr = 0; tr < t.rows; ++tr)
    for (int s = threadIdx.x / 32; s < cap; s += kBlock / 32)
      fn(tr, s, tc);
}

// Raises the kernel's dynamic shared memory limit when a launch needs more
// than the default 48 KB.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int dyn) {
  return dyn > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn)
             : cudaSuccess;
}

// Registers, static and dynamic shared memory, blocks per SM and local
// (spill) bytes of a kernel launched with `threads` threads and `dyn` bytes
// of dynamic shared memory, into out[0..4].
template <class Kernel>
inline int report_occupancy(Kernel kernel, int threads, int dyn, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, dyn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, dyn);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = dyn;
  out[3] = blocks;
  out[4] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
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
