// T1: K2's ref-based step (forces + Euler + bounce + skin displacement)
// as a PERSISTENT kernel that stages the next tile's window while it
// computes the current one: the reference's double-buffering experiment.
//
// Replaces the TPU kernel `_dbuf_kernel` / `make_dbuf` (tools/exp_dbuf.py:38,
// :169; its pl.pallas_call :182), which computes `forces_integrate_pallas`'s
// function and has each grid step prefetch the next row block's slabs into
// a two-slot scratch by async DMA before its own pair loop.  This kernel
// computes K2's function (csrc/forces_integrate.cu) with K2's arithmetic, so
// its four planes and its displacement max are bitwise K2's.
//
// What bounds it on the H100: K2's bytes, 11 planes (7 read, 4 written):
// 157 MB at the 1M planes [696, 8, 640].  K2 runs at about half that bound,
// and with its taps removed still takes ~0.065 of its ~0.088 ms at 1M: its
// memory phases bind, and each of its blocks stages, then taps, in turn
// (bgf::stage_force_window's loads are synchronous), so a block's SM slot
// idles on the loads unless another resident block has taps to run.
//
// Design: about blocks-per-SM x SMs blocks, each walking the interior
// tiles with a stride of the grid (the ghost tiles' fills first, in the
// same stride).  A block keeps a ring of two stages in shared memory, each
// sized at cap slots: the tile's window and its one-cell ring as K2 stages
// it, (x, y, vx, vy) as a float4 and rho in the float2 that will hold the
// EOS pair, and the tile rows of the references ref_x, ref_y.  Before it
// computes tile i it issues tile i+1's copies (cp.async, 4 bytes each,
// each field straight into its place in the float4 and the float2;
// bgf_async.cuh; the next tile's slot bound kmax read from occ first),
// commits them as a group and waits only for tile i's group.  Once a
// stage has landed, one pass counts each window cell's live prefix and
// turns the staged rho into (p, 1/rho) in place, with the twin's float
// operations; then K2's own pair listing, taps (bgf::tile_accel on the
// stage), epilogue (bgf::integrate) and displacement max against the
// staged references.  A dead slot's x and y come from the staged window
// below kmax (FAR past it, where every slot holds FAR), as K5 takes them.
// One bgf::block_max_atomic per block, at the end: the max does not depend
// on the order.  Two stages of 44 KB and ~4.6 KB of lists come to ~93 KB
// a block at cap 8: two blocks per SM, against K2's five at 41 KB (512
// threads a block took 84 registers, one block per SM, and ran slower).

#include "bgf_async.cuh"
#include "bgf_common.cuh"

namespace {

constexpr int kBlock = bgf::kThreads;  // 256, as K2 (512 measured slower)

// Floats of one window field and of one reference field at cap slots; a
// stage holds the (x, y, vx, vy) window as float4, the (rho -> p, 1/rho)
// window as float2 and the two reference fields.
__host__ __device__ __forceinline__ int win_floats(int cap) {
  return bgf::kWinRows * cap * bgf::kWinCols;
}
__host__ __device__ __forceinline__ int ref_floats(int cap) {
  return bgf::kTileRows * cap * bgf::kWinCols;
}
__host__ __device__ __forceinline__ int stage_floats(int cap) {
  return 6 * win_floats(cap) + 2 * ref_floats(cap);
}

// Dynamic shared memory: two stages, the window counts, the pair list and
// the pair count.
int dbuf_smem(int cap) {
  return 2 * stage_floats(cap) * 4 + bgf::kWinRows * bgf::kWinCols * 4 +
         bgf::kTileCells * cap * 4 + 4;
}

struct Stage {
  float4* win;      // (x, y, vx, vy), window slot (wr, kj, wc) at
                    // (wr * kmax + kj) * kWinCols + wc
  float2* eos;      // (rho, -) as copied, then (p, 1/rho)
  float* ref_x;     // tile slot (tr, s, tc) at (tr * kmax + s) * kWinCols
  float* ref_y;     // + tc
};

__device__ __forceinline__ Stage stage_at(float* ring, int st, int cap) {
  float* S = ring + st * stage_floats(cap);
  const int w = win_floats(cap);
  return Stage{reinterpret_cast<float4*>(S),
               reinterpret_cast<float2*>(S + 4 * w), S + 6 * w,
               S + 6 * w + ref_floats(cap)};
}

// Issues the copies of tile t's window (slots kj < kmax) and its reference
// rows into stage S, each field straight into its place in the float4 and
// float2 windows, and stores (FAR, FAR, 0, 0) past the tile's ring (the
// EOS pass writes (0, 0) there).  As bgf::stage_window: a thread per
// window cell (a warp per window row, so its copies are coalesced) walks
// the cell's slots.
__device__ __forceinline__ void issue_stage(
    const bgf::Tile& t, int kmax, int cap, int nx_pad,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const float* __restrict__ ref_x,
    const float* __restrict__ ref_y, const Stage& S) {
  using namespace bgf;
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  for (int c = threadIdx.x; c < kWinRows * kWinCols; c += kBlock) {
    const int wr = c / kWinCols;
    const int wc = c % kWinCols;
    int i = wr * kmax * kWinCols + wc;
    if (wr < t.rows + 2 && wc < t.cols + 2) {
      long long g = base + static_cast<long long>(wr) * cap * nx_pad +
                    wrap_col(t.col0 - 1 + wc, nx_pad);
      for (int kj = 0; kj < kmax; ++kj, i += kWinCols, g += nx_pad) {
        cp_async4(&S.win[i].x, x + g);
        cp_async4(&S.win[i].y, y + g);
        cp_async4(&S.win[i].z, vx + g);
        cp_async4(&S.win[i].w, vy + g);
        cp_async4(&S.eos[i].x, rho + g);
      }
    } else {
      for (int kj = 0; kj < kmax; ++kj, i += kWinCols)
        S.win[i] = make_float4(kFar, kFar, 0.0f, 0.0f);
    }
  }
  for (int c = threadIdx.x; c < kTileRows * kWinCols; c += kBlock) {
    const int tr = c / kWinCols;
    const int tc = c % kWinCols;
    if (tr >= t.rows || tc >= t.cols) continue;
    int i = tr * kmax * kWinCols + tc;
    long long g = base + tile_offset(t, tr, 0, tc, cap, nx_pad);
    for (int s = 0; s < kmax; ++s, i += kWinCols, g += nx_pad) {
      cp_async4(S.ref_x + i, ref_x + g);
      cp_async4(S.ref_y + i, ref_y + g);
    }
  }
}

__global__ void __launch_bounds__(kBlock) dbuf_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const float* __restrict__ ref_x,
    const float* __restrict__ ref_y, const int* __restrict__ occ,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, unsigned int* __restrict__ disp_bits, int cap,
    int nx_pad, int tb, int nb, bgf::ForceConsts fc, float rho0, float k,
    bgf::IntegrateConsts ic) {
  using namespace bgf;
  const int per_rb = ((tb + kTileRows - 1) / kTileRows) *
                     ((nx_pad + kTileCols - 1) / kTileCols);
  // the ghost blocks' tiles (row blocks 0 and nb + 1): K2's fills
  for (int b = blockIdx.x; b < 2 * per_rb; b += gridDim.x) {
    const Tile t = tile_at(b < per_rb ? b : b + nb * per_rb, nx_pad, tb);
    const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ox[g] = kFar;
      oy[g] = kFar;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
    });
  }

  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);  // two stages
  int* cnt = reinterpret_cast<int*>(ring + 2 * stage_floats(cap));
  int* pairs = cnt + kWinRows * kWinCols;
  int* n_pairs = pairs + kTileCells * cap;

  const int n_tiles = nb * per_rb;  // interior tiles, from row block 1 on
  float d2 = 0.0f;
  if (static_cast<int>(blockIdx.x) < n_tiles) {
    const Tile t0 = tile_at(blockIdx.x + per_rb, nx_pad, tb);
    issue_stage(t0, block_kmax(occ, nb, t0.rb - 1), cap, nx_pad, x, y, vx,
                vy, rho, ref_x, ref_y, stage_at(ring, 0, cap));
  }
  cp_async_commit();
  int st = 0;
  for (int b = blockIdx.x; b < n_tiles; b += gridDim.x, st ^= 1) {
    // stage ahead: tile b + gridDim.x into the other stage, which the
    // previous iteration finished reading before its closing sync
    const int b_next = b + gridDim.x;
    if (b_next < n_tiles) {
      const Tile tn = tile_at(b_next + per_rb, nx_pad, tb);
      issue_stage(tn, block_kmax(occ, nb, tn.rb - 1), cap, nx_pad, x, y, vx,
                  vy, rho, ref_x, ref_y, stage_at(ring, st ^ 1, cap));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();

    const Tile t = tile_at(b + per_rb, nx_pad, tb);
    const int kmax = block_kmax(occ, nb, t.rb - 1);
    const Stage S = stage_at(ring, st, cap);
    const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;

    // counts, and the staged rho turned into the EOS pair in place: (p,
    // 1/rho) with the twin's float operations, (0, 0) past the tile's ring
    // (K2's)
    for (int c = threadIdx.x; c < kWinRows * kWinCols; c += kBlock) {
      const int wr = c / kWinCols;
      const int wc = c - wr * kWinCols;
      const bool in = wr < t.rows + 2 && wc < t.cols + 2;
      int n = 0;
      for (int kj = 0; kj < kmax; ++kj) {
        const int i = (wr * kmax + kj) * kWinCols + wc;
        n += n == kj && S.win[i].x < kHalfFar;
        const float rg = S.eos[i].x;
        S.eos[i] = in ? make_float2(k * fmaxf(rg - rho0, 0.0f),
                                    1.0f / fmaxf(rg, 1.0e-12f))
                      : make_float2(0.0f, 0.0f);
      }
      cnt[c] = n;
    }
    __syncthreads();
    if (threadIdx.x < 32) list_pairs(t, kmax, cnt, pairs, n_pairs);
    __syncthreads();

    // K2's taps, epilogue and displacement
    const int np = *n_pairs;
    const int rs = kmax * kWinCols;  // window row stride
    for (int p = threadIdx.x; p < np; p += kBlock) {
      const int cell = pairs[p] >> 8;
      const int s = pairs[p] & 255;
      const int tr = cell / kTileCols;
      const int tc = cell - tr * kTileCols;
      const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
      const float4 own = S.win[own_i];
      const float2 a = tile_accel(S.win, S.eos, tr * rs + tc, rs,
                                  neighbour_counts(cnt, tr, tc).x, own,
                                  S.eos[own_i].x, fc);
      float nx, ny, nvx, nvy;
      const bool live = integrate(own.x, own.y, own.z, own.w, a.x, a.y, ic,
                                  nx, ny, nvx, nvy);
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ox[g] = nx;
      oy[g] = ny;
      ovx[g] = nvx;
      ovy[g] = nvy;
      if (live) {
        const int r = (tr * kmax + s) * kWinCols + tc;
        const float drx = nx - S.ref_x[r];
        const float dry = ny - S.ref_y[r];
        d2 = fmaxf(d2, __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)));
      }
    }
    // dead slots: x and y as they are, zero velocity
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      if (s >= cnt[(tr + 1) * kWinCols + tc + 1]) {
        const float4 v = s < kmax
                             ? S.win[((tr + 1) * kmax + s) * kWinCols + tc + 1]
                             : make_float4(kFar, kFar, 0.0f, 0.0f);
        const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
        ox[g] = v.x;
        oy[g] = v.y;
        ovx[g] = 0.0f;
        ovy[g] = 0.0f;
      }
    });
    __syncthreads();  // the stage is read: the next iteration refills it
  }
  cp_async_wait<0>();
  block_max_atomic(d2, disp_bits);
}

// Blocks per SM x SMs of the current device: the persistent grid.
cudaError_t grid_size(int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = bgf::allow_smem(dbuf_kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dbuf_kernel,
                                                        kBlock, smem);
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

// The arguments of bgf_forces_integrate's ref-based form (every lane in
// the displacement max).
extern "C" int bgf_forces_integrate_dbuf(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* rho, const float* ref_x, const float* ref_y, const int* occ,
    float* ox, float* oy, float* ovx, float* ovy, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, float h, float m_half,
    float spiky_c, float visc_mc, float rho0, float k, float dt, float x_min,
    float x_max, float bounce, float floor_y, cudaStream_t stream) {
  const int smem = dbuf_smem(cap);
  int blocks = 0;
  cudaError_t err = grid_size(smem, &blocks);
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = static_cast<int>(bgf::tiles_for(ny_pad, nx_pad, tb));
  dbuf_kernel<<<blocks < tiles ? blocks : tiles, kBlock, smem, stream>>>(
      x, y, vx, vy, rho, ref_x, ref_y, occ, ox, oy, ovx, ovy,
      reinterpret_cast<unsigned int*>(disp), cap, nx_pad, tb, nb,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_forces_integrate_dbuf_occupancy(int cap, int* out) {
  return bgf::report_occupancy(dbuf_kernel, kBlock, dbuf_smem(cap), out);
}

// The persistent grid the launcher takes at slot capacity cap: blocks per
// SM x SMs of the current device, into out[0].
extern "C" int bgf_forces_integrate_dbuf_grid(int cap, int* out) {
  return static_cast<int>(grid_size(dbuf_smem(cap), out));
}
