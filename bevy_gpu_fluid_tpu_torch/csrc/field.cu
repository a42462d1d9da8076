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
//
// What bounds it on the H100: instruction issue on the L1/L2-resident taps,
// as K1.  Device memory sees one read of the x and y slots below the row
// bounds (never the slots past kmax) and one write of the field; the work
// is ~10 float operations per pixel and tap, P^2 pixels per cell, 9 * kmax
// taps, which at the 1M-particle shapes [696, 8, 640] with P = 2 outweighs
// the bytes: on paper the kernel is bound by operations.
// Design: one thread per real cell, threads along the columns (coalesced
// neighbour loads; the kj bound is uniform across a warp).  The thread
// keeps its P x P sums in registers (P is a template parameter, 1..4), so
// each neighbour (x, y) load serves P^2 pixels.

#include "bgf_common.cuh"

namespace {

template <int P>
__global__ void field_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const int* __restrict__ occ,
                             float* __restrict__ out, int cap, int nx_pad,
                             int tb, int nb, int row0, int nx, int ny,
                             float ox, float oy, float cs, float csp,
                             float h2, float coeff) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nx) * ny) return;
  const int cx = static_cast<int>(t % nx);
  const int cy = static_cast<int>(t / nx);
  const int row = row0 + cy;
  const int col = cx + 1;
  const int kmax = bgf::block_kmax(occ, nb, row / tb - 1);
  const float base_x = __fadd_rn(ox, __fmul_rn(static_cast<float>(cx), cs));
  const float base_y = __fadd_rn(oy, __fmul_rn(static_cast<float>(cy), cs));
  float px[P];
  float py[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const float off = __fmul_rn(static_cast<float>(s) + 0.5f, csp);
    px[s] = __fadd_rn(base_x, off);
    py[s] = __fadd_rn(base_y, off);
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

template <int P>
void launch_field(const float* x, const float* y, const int* occ, float* out,
                  int cap, int nx_pad, int tb, int nb, int row0, int nx,
                  int ny, float ox, float oy, float cs, float csp, float h2,
                  float coeff, cudaStream_t stream) {
  const long long cells = static_cast<long long>(nx) * ny;
  field_kernel<P><<<bgf::blocks_for(cells), bgf::kThreads, 0, stream>>>(
      x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox, oy, cs, csp, h2,
      coeff);
}

}  // namespace

extern "C" int bgf_field(const float* x, const float* y, const int* occ,
                         float* out, int ny_pad, int cap, int nx_pad, int tb,
                         int nb, int row0, int nx, int ny, int p, float ox,
                         float oy, float cs, float csp, float h2, float coeff,
                         cudaStream_t stream) {
  if (ny_pad != (nb + 2) * tb) return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 1:
      launch_field<1>(x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox,
                      oy, cs, csp, h2, coeff, stream);
      break;
    case 2:
      launch_field<2>(x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox,
                      oy, cs, csp, h2, coeff, stream);
      break;
    case 3:
      launch_field<3>(x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox,
                      oy, cs, csp, h2, coeff, stream);
      break;
    case 4:
      launch_field<4>(x, y, occ, out, cap, nx_pad, tb, nb, row0, nx, ny, ox,
                      oy, cs, csp, h2, coeff, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
