// K4: the SPH density field at P x P subpixels per cell (field raster).
//
// Replaces the TPU kernel `_field_kernel` / `field_density_pallas`
// (bevy_gpu_fluid_tpu/render/raster.py:220, :279).  For every real cell
// (cx, cy) and subpixel (sx, sy) the pixel centre is
//   px = (ox + cx * cs) + (sx + 0.5) * (cs / P)
//   py = (oy + cy * cs) + (sy + 0.5) * (cs / P)
// in float32, each operation rounded once (__fmul_rn / __fadd_rn, so FMA
// contraction cannot move the pixel, as in the Pallas kernel and the PyTorch
// twin render/raster.field_density), and
//   rho = coeff * sum_j max(h^2 - |p - x_j|^2, 0)^3,  coeff = m * 4 / (pi h^8)
// over the 3x3 neighbour cells x kmax slots in (kj, dx, dy) order, kmax the
// row block's bound from occ (ops/reslot.block_kmax3).  The output is the
// finished field float32 [ny * P, nx * P], world orientation (row 0 at the
// bottom), element (cy * P + sy, cx * P + sx): the Pallas kernel's
// [ny_pad, P^2, nx_pad] intermediate and its transpose are never formed.
// P is a run-time argument, any P >= 1.
//
// What bounds it on the H100.  It must read the x and y slots below each
// row's bound and write the field (19 MB at the 1M-particle shapes [696, 8,
// 640] with P = 2) and do ~10 float operations per pixel and live
// neighbour slot (36M pixel taps there): on paper it is bound by bytes.
// On the card it is held by instruction issue on its taps (PERF.md).
//
// Two kernels, chosen by P:
// * P <= kCellP: field_cell_kernel<P>, a thread per real cell, threads
//   along the columns (coalesced neighbour loads through L1; the kj bound
//   is uniform across a warp), its P x P sums in registers so each (x, y)
//   load serves P^2 pixels, 9 x the row block's kmax taps.  At 1M with
//   P = 2 it runs 55M pixel taps where a loop to the largest of each
//   cell's 9 counts would run 51M: in the wet bulk that largest count is
//   close to kmax.  A halo-tile kernel with a thread per cell, its cells
//   sorted by bound, measured slower (0.026 against 0.023 ms, half of it
//   staging: PERF.md).
// * P > kCellP: field_tile_kernel, the halo tile of bgf_common.cuh
//   (FieldTile, 4 x 30 cells and a one-cell ring) on the interior tiles
//   that hold real cells.  A block stages its window's (x, y) below kmax
//   once, counts each window cell's live prefix and takes each tile cell's
//   slot bound, the largest of its 9 cells' counts; a warp takes one pixel
//   row of the tile at a time, a lane per pixel, so its stores are
//   coalesced straight from registers with no output buffer in shared
//   memory to bound P.  A tap on
//   a FAR slot adds exactly +0 to a sum that starts at +0 and never holds
//   -0, so stopping at the bound gives the sum over all 9 x kmax taps bit
//   for bit (pinned on the twin in tests/test_torch_stencil_tiles.py), and
//   a cell whose 9 cells hold no particle writes +0 with no taps.

#include "bgf_common.cuh"

namespace {

constexpr int kCellP = 4;       // P up to which field_cell_kernel<P> runs
constexpr int kFieldRows = 4;   // field_tile_kernel's tile rows
constexpr int kFieldCols = 30;  // with the ring, one lane per column
constexpr int kBlock = 128;     // field_tile_kernel's threads per block
using FieldTile = bgf::HaloTile<kFieldRows, kFieldCols, 1>;
constexpr int kCells = kFieldRows * kFieldCols;

// The pixel centre coordinate o + c * cs + (s + 0.5) * csp, each operation
// rounded once.
__device__ __forceinline__ float pixel_centre(float o, int c, int s,
                                              float cs, float csp) {
  return __fadd_rn(__fadd_rn(o, __fmul_rn(static_cast<float>(c), cs)),
                   __fmul_rn(static_cast<float>(s) + 0.5f, csp));
}

template <int P>
__global__ void field_cell_kernel(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  const int* __restrict__ occ,
                                  float* __restrict__ out, int cap,
                                  int nx_pad, int tb, int nb, int row0,
                                  int nx, int ny, float ox, float oy,
                                  float cs, float csp, float h2,
                                  float coeff) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nx) * ny) return;
  const int cx = static_cast<int>(t % nx);
  const int cy = static_cast<int>(t / nx);
  const int row = row0 + cy;
  const int col = cx + 1;
  const int kmax = bgf::block_kmax(occ, nb, row / tb - 1);
  float px[P];
  float py[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    px[s] = pixel_centre(ox, cx, s, cs, csp);
    py[s] = pixel_centre(oy, cy, s, cs, csp);
  }
  float acc[P * P];
#pragma unroll
  for (int s = 0; s < P * P; ++s) acc[s] = 0.0f;
  for (int kj = 0; kj < kmax; ++kj) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int c = bgf::wrap_col(col + dx, nx_pad);
      for (int dy = -1; dy <= 1; ++dy) {
        const long long j =
            (static_cast<long long>(row + dy) * cap + kj) * nx_pad + c;
        const float rx = x[j];
        const float ry = y[j];
#pragma unroll
        for (int sy = 0; sy < P; ++sy) {
#pragma unroll
          for (int sx = 0; sx < P; ++sx)
            acc[sy * P + sx] += bgf::poly6_term(px[sx] - rx, py[sy] - ry, h2);
        }
      }
    }
  }
  const long long width = static_cast<long long>(nx) * P;
#pragma unroll
  for (int sy = 0; sy < P; ++sy) {
#pragma unroll
    for (int sx = 0; sx < P; ++sx) {
      out[(static_cast<long long>(cy) * P + sy) * width + cx * P + sx] =
          acc[sy * P + sx] * coeff;
    }
  }
}

// Dynamic shared memory of field_tile_kernel: the (x, y) window, the
// window counts and each tile cell's slot bound.
int tile_smem(int cap) {
  return FieldTile::kWinRows * cap * bgf::kWinCols * 8 +
         FieldTile::kWinRows * bgf::kWinCols * 4 + kCells * 4;
}

__global__ void __launch_bounds__(kBlock)
    field_tile_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const int* __restrict__ occ, float* __restrict__ out,
                      int p, int cap, int nx_pad, int tb, int nb, int row0,
                      int nx, int ny, float ox, float oy, float cs,
                      float csp, float h2, float coeff) {
  using namespace bgf;
  using G = FieldTile;
  const Tile t = tile_of<G>(nx_pad, tb);
  // the tile's real cells: tile rows [r_lo, r_hi), tile columns [c_lo, c_hi)
  const int r_lo = max(row0 - t.row0, 0);
  const int r_hi = min(row0 + ny - t.row0, t.rows);
  const int c_lo = max(1 - t.col0, 0);
  const int c_hi = min(nx + 1 - t.col0, t.cols);
  if (r_lo >= r_hi || c_lo >= c_hi) return;  // ghost rows or columns only

  extern __shared__ float2 win[];  // G::kWinRows x kmax x kWinCols
  int* cnt = reinterpret_cast<int*>(win + G::kWinRows * cap * kWinCols);
  int* bound = cnt + G::kWinRows * kWinCols;
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  const int kmax = block_kmax(occ, nb, t.rb - 1);
  const float* xb = x + base;
  const float* yb = y + base;
  stage_window<kBlock, G>(t, kmax, cap, nx_pad, cnt, [&](int i, int off) {
    const float2 v =
        off < 0 ? make_float2(kFar, kFar) : make_float2(xb[off], yb[off]);
    win[i] = v;
    return v.x;
  });
  __syncthreads();
  for (int c = threadIdx.x; c < kCells; c += kBlock) {
    const int tr = c / kFieldCols;
    bound[c] = neighbour_counts(cnt, tr, c - tr * kFieldCols).x;
  }
  __syncthreads();

  const int rs = kmax * kWinCols;  // window row stride
  const long long width = static_cast<long long>(nx) * p;
  const int lane = threadIdx.x & 31;
  // lane -> (tile column, subpixel) of its first pixel in a row, and the
  // step of 32 pixels in the same terms
  const int col_step = 32 / p;
  const int sub_step = 32 - col_step * p;
  const int lane_col = lane / p;
  const int lane_sub = lane - lane_col * p;
  const int n_px = (c_hi - c_lo) * p;  // the tile's pixels per row
  for (int pr = threadIdx.x >> 5; pr < (r_hi - r_lo) * p;
       pr += kBlock / 32) {
    const int tr = r_lo + pr / p;
    const int sy = pr - (tr - r_lo) * p;
    const int cy = t.row0 + tr - row0;
    const float py = pixel_centre(oy, cy, sy, cs, csp);
    float* orow = out + (static_cast<long long>(cy) * p + sy) * width;
    int tc = c_lo + lane_col;
    int sx = lane_sub;
    for (int pc = lane; pc < n_px; pc += 32) {
      const int cx = t.col0 + tc - 1;
      const float px = pixel_centre(ox, cx, sx, cs, csp);
      const int kb = bound[tr * kFieldCols + tc];
      const int b0 = tr * rs + tc;  // window slot (tr, 0, tc): dx = dy = -1
      float acc = 0.0f;
      for (int kj = 0; kj < kb; ++kj) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float2 w = win[b0 + dy * rs + kj * kWinCols + dx];
            acc += poly6_term(px - w.x, py - w.y, h2);
          }
      }
      orow[cx * p + sx] = acc * coeff;
      tc += col_step;
      sx += sub_step;
      if (sx >= p) {
        sx -= p;
        ++tc;
      }
    }
  }
}

template <int P>
cudaError_t launch_cells(const float* x, const float* y, const int* occ,
                         float* out, int cap, int nx_pad, int tb, int nb,
                         int row0, int nx, int ny, float ox, float oy,
                         float cs, float csp, float h2, float coeff,
                         cudaStream_t stream) {
  const long long cells = static_cast<long long>(nx) * ny;
  field_cell_kernel<P><<<bgf::blocks_for(cells), bgf::kThreads, 0, stream>>>(
      x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox, oy, cs, csp, h2,
      coeff);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bgf_field(const float* x, const float* y, const int* occ,
                         float* out, int ny_pad, int cap, int nx_pad, int tb,
                         int nb, int row0, int nx, int ny, int p, float ox,
                         float oy, float cs, float csp, float h2, float coeff,
                         cudaStream_t stream) {
  if (ny_pad != (nb + 2) * tb || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define BGF_CELLS(P)                                                     \
  launch_cells<P>(x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox, \
                  oy, cs, csp, h2, coeff, stream)
  cudaError_t err;
  switch (p <= kCellP ? p : 0) {
    case 1: err = BGF_CELLS(1); break;
    case 2: err = BGF_CELLS(2); break;
    case 3: err = BGF_CELLS(3); break;
    case 4: err = BGF_CELLS(4); break;
    default: {
      const int smem = tile_smem(cap);
      err = bgf::allow_smem(field_tile_kernel, smem);
      if (err != cudaSuccess) break;
      field_tile_kernel<<<bgf::tiles_for<FieldTile>(ny_pad, nx_pad, tb),
                          kBlock, smem, stream>>>(
          x, y, occ, out, p, cap, nx_pad, tb, nb, row0, nx, ny, ox, oy, cs,
          csp, h2, coeff);
      err = cudaGetLastError();
    }
  }
#undef BGF_CELLS
  return static_cast<int>(err);
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of field_tile_kernel (the kernel of P > kCellP) at slot
// capacity cap, into out[0..4].
extern "C" int bgf_field_occupancy(int cap, int* out) {
  return bgf::report_occupancy(field_tile_kernel, kBlock, tile_smem(cap),
                               out);
}
