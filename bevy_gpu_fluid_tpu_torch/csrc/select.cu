// K6: the planar rebin's routing pass ("select").
//
// Replaces the TPU kernel `_select_kernel` / `select_pallas`
// (bevy_gpu_fluid_tpu/ops/reslot.py:393, :455), with K3's clip range and
// origin as data (bgf::CellGrid: single-chip or a slab's).  For
// every target cell it scans the candidate slots of its 3x3 neighbourhood
// in (kj, dx, dy) order, as K3 (reslot.cu, bgf::scan_candidates) does: a
// candidate matches when it is live (x < FAR/2) and its clipped cell
// (bgf::cell_of, the same arithmetic as K3's) is the target.  For the n-th
// match it writes the candidate's routing code kj * 9 + (dx + 1) * 3 +
// (dy + 1) into output slot n, -1 into the slots no match reaches, and the
// match count into the per-cell count plane.  The code plane is int32 or
// int8 (the caller's choice; codes span [-1, 72)); the ghost blocks get -1
// and a zero count.  K7 (apply_code.cu) then routes each payload plane
// through it.
//
// What bounds it on the H100: device memory, on paper.  It must read the
// x and y slots below each row block's bound and write the code plane and
// the counts: at the 1M-particle shapes [696, 8, 640] 12.5 MB + 14.3 MB
// (int32 codes) + 1.8 MB.  A thread per cell scanning its 9 x kmax
// candidates (K3's scan) re-reads them through L1/L2 and takes both
// clipped coordinates of a live candidate once per target it is scanned
// for, up to 9 times.  On the card the tile's phases (staging, scan,
// store) run one after another in each block, and it stays short of its
// bound (PERF.md).
//
// Design: the halo tile of bgf_common.cuh (SelectTile, 4 x 30 cells and a
// one-cell ring).  A block stages its window below kmax once and, while it
// stages, turns each live slot into the flat plane index of its clipped
// cell, (row0 + cy) * nx_pad + cx + 1, and each dead slot into -1: one
// cell_of pair per staged slot (y is read only for live slots), and the
// window holds 4 bytes a slot.  A thread per tile cell then compares the
// stored ids with its own index in (kj, dx, dy) order up to the largest
// live count of its 9 cells: live slots are a prefix of each cell
// (tests/test_torch_stencil_tiles.py), so every slot past its cell's
// count is dead and matches nothing, and the ranks, hence the codes, are
// K3's bit for bit.  The codes go to shared memory ([slot][cell]) and one
// coalesced pass writes all cap layers (-1 past each cell's count), then
// the counts.  Ghost-block tiles write -1 and 0 without staging.
//
// K3 keeps bgf::scan_candidates; the two share cell_of and code_of, and
// chip_smoke.py holds reslot_planar (K6 + K7) bitwise against K3.

#include <cstdint>

#include "bgf_common.cuh"

namespace {

constexpr int kSelectRows = 4;  // tile rows (2 and 8 measured: PERF.md)
constexpr int kSelectCols = 30;  // with the ring, one lane per column
constexpr int kBlock = 128;     // per block (256 measured: PERF.md)
using SelectTile = bgf::HaloTile<kSelectRows, kSelectCols, 1>;
constexpr int kCells = kSelectRows * kSelectCols;

// Dynamic shared memory: the window's cell ids, the window counts, the
// tile's codes [cap][cell] and its match counts.
int select_smem(int cap) {
  return SelectTile::kWinRows * cap * bgf::kWinCols * 4 +
         SelectTile::kWinRows * bgf::kWinCols * 4 + kCells * cap * 4 +
         kCells * 4;
}

template <typename Code>
__global__ void __launch_bounds__(kBlock)
    select_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const int* __restrict__ occ, Code* __restrict__ code,
                  int* __restrict__ cnt, int cap, int nx_pad, int tb, int nb,
                  bgf::CellGrid g) {
  using namespace bgf;
  using G = SelectTile;
  const Tile t = tile_of<G>(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  extern __shared__ int ids[];  // G::kWinRows x kmax x kWinCols
  int* wcnt = ids + G::kWinRows * cap * kWinCols;
  int* codes = wcnt + G::kWinRows * kWinCols;
  int* matches = codes + kCells * cap;
  const bool ghost = t.rb == 0 || t.rb == nb + 1;

  if (!ghost) {
    const int kmax = block_kmax(occ, nb, t.rb - 1);
    const float* xb = x + base;
    const float* yb = y + base;
    stage_window<kBlock, G>(t, kmax, cap, nx_pad, wcnt, [&](int i, int off) {
      const float xv = off < 0 ? kFar : xb[off];
      int id = -1;
      if (xv < kHalfFar)
        id = (g.row0 + cell_of(yb[off], g.origin_y, g.inv, 0, g.ny - 1)) *
                 nx_pad +
             cell_of(xv, g.origin_x, g.inv, g.clip_lo, g.clip_hi) + 1;
      ids[i] = id;
      return xv;
    });
    __syncthreads();
    const int rs = kmax * kWinCols;  // window row stride
    for (int c = threadIdx.x; c < kCells; c += kBlock) {
      const int tr = c / kSelectCols;
      const int tc = c - tr * kSelectCols;
      if (tr >= t.rows || tc >= t.cols) continue;
      const int target = (t.row0 + tr) * nx_pad + t.col0 + tc;
      const int kb = neighbour_counts(wcnt, tr, tc).x;
      const int b0 = tr * rs + tc;  // window slot (tr, 0, tc): dx = dy = -1
      int n = 0;
      for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            if (ids[b0 + dy * rs + kj * kWinCols + dx] == target) {
              if (n < cap)
                codes[n * kCells + c] = code_of(kj, dx - 1, dy - 1);
              ++n;
            }
      }
      matches[c] = n;
    }
    __syncthreads();
  }
  Code* out = code + base;
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    const int c = tr * kSelectCols + tc;
    out[tile_offset<G>(t, tr, s, tc, cap, nx_pad)] = static_cast<Code>(
        !ghost && s < matches[c] ? codes[s * kCells + c] : -1);
  });
  for (int c = threadIdx.x; c < kCells; c += kBlock) {
    const int tr = c / kSelectCols;
    const int tc = c - tr * kSelectCols;
    if (tr < t.rows && tc < t.cols)
      cnt[static_cast<long long>(t.row0 + tr) * nx_pad + t.col0 + tc] =
          ghost ? 0 : matches[c];
  }
}

template <typename Code>
cudaError_t launch_select(const float* x, const float* y, const int* occ,
                          Code* code, int* cnt, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, bgf::CellGrid g,
                          cudaStream_t stream) {
  const int smem = select_smem(cap);
  const cudaError_t err = bgf::allow_smem(select_kernel<Code>, smem);
  if (err != cudaSuccess) return err;
  select_kernel<Code>
      <<<bgf::tiles_for<SelectTile>(ny_pad, nx_pad, tb), kBlock, smem,
         stream>>>(x, y, occ, code, cnt, cap, nx_pad, tb, nb, g);
  return cudaGetLastError();
}

}  // namespace

// code_bytes: 4 for an int32 code plane, 1 for int8; any other value
// returns cudaErrorInvalidValue without launching.
extern "C" int bgf_select(const float* x, const float* y, const int* occ,
                          void* code, int* cnt, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, int row0,
                          int clip_lo, int clip_hi, int ny, int code_bytes,
                          float origin_x, float origin_y, float inv,
                          cudaStream_t stream) {
  const bgf::CellGrid g{ny, row0, clip_lo, clip_hi, origin_x, origin_y, inv};
  if (code_bytes == 4)
    return static_cast<int>(
        launch_select(x, y, occ, static_cast<int32_t*>(code), cnt, ny_pad,
                      cap, nx_pad, tb, nb, g, stream));
  if (code_bytes == 1)
    return static_cast<int>(
        launch_select(x, y, occ, static_cast<int8_t*>(code), cnt, ny_pad,
                      cap, nx_pad, tb, nb, g, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the int32-code kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_select_occupancy(int cap, int* out) {
  return bgf::report_occupancy(select_kernel<int32_t>, kBlock,
                               select_smem(cap), out);
}
