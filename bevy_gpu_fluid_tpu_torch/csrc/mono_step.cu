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
// A dead (FAR) slot inside kmax_d sums its FAR-FAR "self-pairs", so rho on
// dead slots differs from K1's; live slots match K1 exactly (extra taps add
// exact zeros), and dead slots never reach a live slot's force (hr = 0).
// The pair terms and the epilogue are bgf_common.cuh's, shared with K1/K2.
//
// What bounds it on the H100: at the small grids it serves (under 12 row
// blocks, e.g. [104, 8, 128] for 10k particles) neither bytes (11 planes,
// ~5 MB) nor operations (~0.2 GFLOP) but latency: a launch fills fewer
// blocks than the card has SMs.  One launch instead of two, and no rho
// round trip through device memory, is what it saves.
// Design: on the TPU the row-block programs run in sequence and each
// recomputes its halo-row density in VMEM.  Here blocks run in no order,
// so a block owns a tile of tb rows x 16 columns and recomputes rho, p and
// 1/rho for the tile PLUS a one-cell halo ring ((tb + 2) rows x 18 columns,
// all slots) into shared memory, from an x/y window of (tb + 4) rows x 20
// columns; column neighbours wrap modulo nx_pad like the TPU lane roll.
// The forces + Euler + bounce + trigger then read every neighbour from
// shared memory.  At tb = 8, cap = 8 that is 12*8*20 x/y floats plus
// 10*8*18 p/ir/vx/vy floats, 38,400 bytes.  The displacement max is a
// block reduction and one atomicMax on the float bits, as in K2.  Blocks of
// grid row 0 and nb + 1 write the ghost-block fills.

#include "bgf_common.cuh"

namespace {

constexpr int kTile = 16;  // columns per block

__host__ __device__ constexpr int x_cols() { return kTile + 4; }
__host__ __device__ constexpr int v_cols() { return kTile + 2; }

__global__ void mono_step_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ ref_x, const float* __restrict__ ref_y,
    const int* __restrict__ occ, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ ovx, float* __restrict__ ovy,
    float* __restrict__ orho, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, float h2, float coeff, bgf::ForceConsts fc,
    float rho0, float k_eos, bgf::IntegrateConsts ic) {
  const int c0 = blockIdx.x * kTile;
  const int by = blockIdx.y;
  if (by == 0 || by == nb + 1) {  // ghost block: the empty fills
    for (int e = threadIdx.x; e < tb * cap * kTile; e += blockDim.x) {
      const long long g =
          (static_cast<long long>(by) * tb * cap + e / kTile) * nx_pad + c0 +
          e % kTile;
      ox[g] = bgf::kFar;
      oy[g] = bgf::kFar;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
      orho[g] = 0.0f;
    }
    return;  // uniform across the block: no barrier below is reached
  }
  const int r = by - 1;  // interior row block
  const int xr = tb + 4, xc = x_cols();
  const int vr = tb + 2, vc = v_cols();
  extern __shared__ float smem[];
  float* xs = smem;                  // [xr][cap][xc]
  float* ys = xs + xr * cap * xc;
  float* vxs = ys + xr * cap * xc;   // [vr][cap][vc]
  float* vys = vxs + vr * cap * vc;
  float* ps = vys + vr * cap * vc;
  float* irs = ps + vr * cap * vc;

  // ---- load: x/y window rows (r+1)tb-2 .., columns c0-2 ..; velocity
  // window rows (r+1)tb-1 .., columns c0-1 ..
  const int row_x = (r + 1) * tb - 2;
  const int row_v = row_x + 1;
  for (int e = threadIdx.x; e < xr * cap * xc; e += blockDim.x) {
    const long long g =
        (static_cast<long long>(row_x) * cap + e / xc) * nx_pad +
        bgf::wrap_col(c0 - 2 + e % xc, nx_pad);
    xs[e] = x[g];
    ys[e] = y[g];
  }
  for (int e = threadIdx.x; e < vr * cap * vc; e += blockDim.x) {
    const long long g =
        (static_cast<long long>(row_v) * cap + e / vc) * nx_pad +
        bgf::wrap_col(c0 - 1 + e % vc, nx_pad);
    vxs[e] = vx[g];
    vys[e] = vy[g];
  }
  __syncthreads();

  // ---- density (+ EOS) over the tile and its one-cell halo ring
  const int rm = max(r - 1, 0);
  const int rp = min(r + 1, nb - 1);
  const int kmax_f = bgf::block_kmax(occ, nb, r);
  const int kmax_d = max(kmax_f, max(occ[rm], occ[2 * nb + rp]));
  for (int e = threadIdx.x; e < vr * cap * vc; e += blockDim.x) {
    const int c = e % vc;
    const int slot = (e / vc) % cap;
    const int wr = e / vc / cap;  // window row of the v/p/ir slabs
    const int i = ((wr + 1) * cap + slot) * xc + c + 1;
    const float xi = xs[i];
    const float yi = ys[i];
    float acc = 0.0f;
    for (int kj = 0; kj < kmax_d; ++kj) {
      for (int dx = -1; dx <= 1; ++dx) {
        for (int dy = -1; dy <= 1; ++dy) {
          const int j = ((wr + 1 + dy) * cap + kj) * xc + c + 1 + dx;
          acc += bgf::poly6_term(xi - xs[j], yi - ys[j], h2);
        }
      }
    }
    const float rho = acc * coeff;
    ps[e] = k_eos * fmaxf(rho - rho0, 0.0f);
    irs[e] = 1.0f / fmaxf(rho, 1.0e-12f);
    if (wr >= 1 && wr <= tb && c >= 1 && c <= kTile) {
      orho[(static_cast<long long>(row_v + wr) * cap + slot) * nx_pad + c0 +
           c - 1] = rho;
    }
  }
  __syncthreads();

  // ---- forces + Euler + bounce + displacement over the tile's own slots
  float d2 = 0.0f;
  for (int e = threadIdx.x; e < tb * cap * kTile; e += blockDim.x) {
    const int c = e % kTile;
    const int slot = (e / kTile) % cap;
    const int rr = e / kTile / cap;
    const long long g =
        (static_cast<long long>(row_v + 1 + rr) * cap + slot) * nx_pad + c0 +
        c;
    const int ix = ((rr + 2) * cap + slot) * xc + c + 2;
    const int iv = ((rr + 1) * cap + slot) * vc + c + 1;
    const float xi = xs[ix];
    const float yi = ys[ix];
    const float vxi = vxs[iv];
    const float vyi = vys[iv];
    const float p_i = ps[iv];
    float ax = 0.0f;
    float ay = 0.0f;
    for (int kj = 0; kj < kmax_f; ++kj) {
      for (int dx = -1; dx <= 1; ++dx) {
        for (int dy = -1; dy <= 1; ++dy) {
          const int jx = ((rr + 2 + dy) * cap + kj) * xc + c + 2 + dx;
          const int jv = ((rr + 1 + dy) * cap + kj) * vc + c + 1 + dx;
          bgf::add_pair_accel(xi - xs[jx], yi - ys[jx], p_i + ps[jv],
                              irs[jv], vxs[jv] - vxi, vys[jv] - vyi, fc, ax,
                              ay);
        }
      }
    }
    float nx, ny, nvx, nvy;
    const bool live =
        bgf::integrate(xi, yi, vxi, vyi, ax, ay, ic, nx, ny, nvx, nvy);
    ox[g] = nx;
    oy[g] = ny;
    ovx[g] = nvx;
    ovy[g] = nvy;
    if (live) {
      const float drx = nx - ref_x[g];
      const float dry = ny - ref_y[g];
      d2 = fmaxf(d2, drx * drx + dry * dry);
    }
  }
  bgf::block_max_atomic(d2, disp_bits);
}

}  // namespace

extern "C" int bgf_mono_step(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* ref_x, const float* ref_y, const int* occ, float* ox,
    float* oy, float* ovx, float* ovy, float* orho, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, float h, float h2, float coeff,
    float m_half, float spiky_c, float visc_mc, float rho0, float k, float dt,
    float x_min, float x_max, float bounce, float floor_y,
    cudaStream_t stream) {
  if (nx_pad % kTile != 0 || ny_pad != (nb + 2) * tb || tb < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * (tb + 4) * cap * x_cols() +
                       4 * (tb + 2) * cap * v_cols());
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mono_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nx_pad / kTile, nb + 2);
  mono_step_kernel<<<grid, bgf::kThreads, smem, stream>>>(
      x, y, vx, vy, ref_x, ref_y, occ, ox, oy, ovx, ovy, orho,
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb, h2, coeff,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}
