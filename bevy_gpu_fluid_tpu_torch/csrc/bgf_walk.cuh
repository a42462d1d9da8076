// The walk tile of the redesigned kernel experiments T2 (slot-major
// density, exp_tlayout.cu) and T4 (the forces arithmetic variants,
// exp_forces.cu): the window staged in 16-byte chunks from aligned tiles,
// and a tap loop that gives each thread two slots of one cell.  No
// production kernel includes it.
//
// Tiles.  bgf::ring_tile's: kRows x kRingCols (28) cells of one row block
// from column 1 on, over all ny_pad rows, so a window's first column,
// col0 - 1, is a multiple of 4 and a window row of one slot layer (32
// contiguous floats in the dense and in the slot-major layout) is eight
// 16-byte chunks, each all inside the plane or all past its last column
// (nx_pad % 4 == 0).  A chunk past it is FAR without a read; no column
// wraps (a tap of the last tile reaches at most column nx_pad, past the
// edge: FAR, as the wrapped ghost column 0 is in K1 and K8).  Column 0, a
// ghost column (FAR) in no tile, is written by the first tile of each row
// block (lane 31 of its slot pass).
//
// Shared window, column-major: window slot (wr, kj, wc) at kj * kLayer +
// wc * kR + wr, kR >= kRows + 2 and odd, so the lanes of a warp that tap
// the same candidate of neighbouring cells read words kR apart: distinct
// banks; a slot layer, kLayer = kWinCols * kR + 1 slots, odd too, so the
// staging lanes that store one column at four slot layers hit distinct
// banks as well.  The candidate (dx, dy) of the cell whose top-left
// neighbour is window slot b0 (at slot layer 0) sits at b0 + kj * kLayer +
// dx * kR + dy.  The window holds an even number of slots (win_slots), so
// the counts after it, stored as int4s, start 16-byte aligned at any cap.
//
// Items.  A thread takes slots s and s + 1 of one cell (s even; s + 1 dead
// in a cell of odd count: it is neither summed into an output nor written).
// Both slots share the cell's candidates and their bound, so each
// candidate is loaded from shared memory once for two sums.  Warp 0 lists
// the items (cell, s) in (row, slot pair, column) order, so a warp's lanes
// are neighbouring cells and its stores coalesce.  The taps are K1's and
// K8's: every candidate below the largest of the cell's 9 counts, in (kj,
// dx, dy) order (a candidate past its own cell's count is FAR and adds
// exactly +-0, tests/test_torch_stencil_tiles.py).  kSlots = 1 gives back
// K1's and K8's thread per slot for tools/torch_tile_study.py's A/B.  A
// walk of the live candidates alone (a per-lane mask stepped by leading
// zeros) was measured slower on both kernels and dropped (PERF.md).
#pragma once

#include "bgf_common.cuh"
#include "bgf_tma.cuh"

namespace bgf {

constexpr int kChunks = kWinCols / 4;  // 16-byte chunks of a window row

template <int kRows_, int kR_>
struct WalkTile {
  static constexpr int kRows = kRows_;
  static constexpr int kR = kR_;               // column stride, field width
  static constexpr int kWinRows = kRows + 2;
  static constexpr int kLayer = kWinCols * kR + 1;  // a slot layer's slots
  static constexpr int kCells = kRows * kRingCols;
  static_assert(kWinRows <= kR && kR % 2 == 1, "an odd column stride");

  __host__ __device__ static constexpr int at(int kj, int wc, int wr) {
    return kj * kLayer + wc * kR + wr;
  }

  // Window slots at cap slot layers, rounded up to even: what follows a
  // window of 8- or 24-byte slots starts 16-byte aligned.
  __host__ __device__ static constexpr int win_slots(int cap) {
    return kLayer * cap + (cap & 1);
  }
};

// Largest slot capacity: an item holds its first slot in 6 bits.
constexpr int kMaxCap = 64;

constexpr int kGroups = 32 / kChunks;   // slot layers a warp stages at once

// Stages the tile's window in 16-byte chunks and counts each window cell's
// live prefix below kmax into cnt[wr * kWinCols + wc] (cnt 16-byte
// aligned).  A warp per window row wr; lane = q * kGroups + g takes chunk
// q (window columns 4q..4q+3) at the slot layers kj = g, g + kGroups, ...
// below kmax, calling stage(kj, wr, q, in) with in false for a chunk past
// the plane's last column (stage FAR there, no read); stage returns the
// chunk's x.  A column's count is its first dead slot (kmax if none), the
// least over its kGroups lanes.  Rows past the tile's ring are not staged
// (no tap reads them) and count 0.
template <int kBlock, class G, class Stage>
__device__ __forceinline__ void stage_chunks(const Tile& t, int kmax,
                                             int nx_pad, int* cnt,
                                             Stage stage) {
  const int lane = threadIdx.x & 31;
  const int q = lane / kGroups;
  const int g = lane - q * kGroups;
  for (int wr = threadIdx.x / 32; wr < G::kWinRows; wr += kBlock / 32) {
    int4 n = make_int4(0, 0, 0, 0);
    if (wr < t.rows + 2) {
      const bool in = t.col0 - 1 + 4 * q < nx_pad;
      n = make_int4(kmax, kmax, kmax, kmax);
#pragma unroll 2
      for (int kj = g; kj < kmax; kj += kGroups) {
        const float4 v = stage(kj, wr, q, in);
        n.x = n.x == kmax && !(v.x < kHalfFar) ? kj : n.x;
        n.y = n.y == kmax && !(v.y < kHalfFar) ? kj : n.y;
        n.z = n.z == kmax && !(v.z < kHalfFar) ? kj : n.z;
        n.w = n.w == kmax && !(v.w < kHalfFar) ? kj : n.w;
      }
#pragma unroll
      for (int off = 1; off < kGroups; off <<= 1) {
        n.x = min(n.x, __shfl_xor_sync(0xffffffffu, n.x, off));
        n.y = min(n.y, __shfl_xor_sync(0xffffffffu, n.y, off));
        n.z = min(n.z, __shfl_xor_sync(0xffffffffu, n.z, off));
        n.w = min(n.w, __shfl_xor_sync(0xffffffffu, n.w, off));
      }
    }
    if (g == 0) reinterpret_cast<int4*>(cnt)[wr * kChunks + q] = n;
  }
}

// Item slots of a tile of G at slot capacity cap, kSlots slots an item,
// rounded up to a 4-byte multiple.
template <class G, int kSlots>
__host__ __device__ __forceinline__ int item_slots(int cap) {
  return (G::kCells * ((cap + kSlots - 1) / kSlots) + 1) & ~1;
}

// Lists the tile's items, cell << 6 | s (cell = tr * kRingCols + tc, s
// the first slot, a multiple of kSlots), in (row, slot step, column)
// order, and their number into *n_items.  Warp 0 only, once cnt is
// complete; the caller syncs before reading them.
template <int kRows, int kSlots>
__device__ __forceinline__ void list_items(const Tile& t, int kmax,
                                           const int* cnt,
                                           unsigned short* items,
                                           int* n_items) {
  const int lane = threadIdx.x & 31;
  int n_row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    n_row[r] = r < t.rows && lane < t.cols
                   ? cnt[(r + 1) * kWinCols + lane + 1] : 0;
  int base = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    for (int s = 0; s < kmax; s += kSlots) {
      const bool live = s < n_row[r];
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live)
        items[base + __popc(m & ((1u << lane) - 1u))] =
            static_cast<unsigned short>((r * kRingCols + lane) << 6 | s);
      base += __popc(m);
    }
  if (lane == 0) *n_items = base;
}

// Calls tap(j) for the 9 candidates of slot layer kj, in (dx, dy) order:
// window slots b + dx * kR + dy, b the top-left one at that layer.
template <int kR, class Tap>
__device__ __forceinline__ void layer_taps(int b, Tap tap) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) tap(b + dx * kR + dy);
}

// Calls tap(j) for the candidates of the cell whose top-left neighbour is
// window cell (wr, wc), b0 its window slot at layer 0: every candidate
// below the largest of the 9 counts (K1's and K8's loop), in (kj, dx, dy)
// order.
template <int kLayer, int kR, class Tap>
__device__ __forceinline__ void walk_taps(const int* cnt, int wr, int wc,
                                          int b0, Tap tap) {
  const int kb = neighbour_counts(cnt, wr, wc).x;
  for (int kj = 0; kj < kb; ++kj) {
    layer_taps<kR>(b0 + kj * kLayer, tap);
  }
}

// walk_taps two slot layers an iteration (v3's unroll by two), in the same
// order; an odd bound's last layer goes alone.
template <int kLayer, int kR, class Tap>
__device__ __forceinline__ void walk_taps2(const int* cnt, int wr, int wc,
                                           int b0, Tap tap) {
  const int kb = neighbour_counts(cnt, wr, wc).x;
  int kj = 0;
  for (; kj + 1 < kb; kj += 2) {
    layer_taps<kR>(b0 + kj * kLayer, tap);
    layer_taps<kR>(b0 + (kj + 1) * kLayer, tap);
  }
  if (kj < kb) layer_taps<kR>(b0 + kj * kLayer, tap);
}

// Calls fn(tr, s, wc) for every output slot of the tile, wc its window
// column: a warp per (row, slot) layer, a lane per column (wc = lane + 1),
// so the writes coalesce; the first tile's lane 31 takes plane column 0
// (wc = 0), which lies in no tile.
template <int kBlock, class Fn>
__device__ __forceinline__ void for_walk_slots(const Tile& t, int cap,
                                               Fn fn) {
  const int lane = threadIdx.x & 31;
  const int wc = lane < t.cols ? lane + 1
                               : (lane == 31 && t.col0 == 1 ? 0 : -1);
  if (wc < 0) return;
  for (int tr = 0; tr < t.rows; ++tr)
    for (int s = threadIdx.x / 32; s < cap; s += kBlock / 32)
      fn(tr, s, wc);
}

// Blocks of a walk-tiled launch over all ny_pad rows (host side).
inline unsigned walk_tiles(int ny_pad, int nx_pad, int tb, int rows) {
  return static_cast<unsigned>((ny_pad / tb) * ((tb + rows - 1) / rows) *
                               ring_tiles_x(nx_pad));
}

}  // namespace bgf
