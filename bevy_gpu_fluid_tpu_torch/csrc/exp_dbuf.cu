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
// (bgf::stage_force_window's loads are synchronous).
//
// Design: TMA boxes into a shared-memory stage (bgf_tma.cuh), a producer
// warp and consumer warps.  One tensor map per input plane (x, y, vx, vy,
// rho, ref_x, ref_y), each the dense plane [ny_pad, cap, nx_pad] as dims
// {nx_pad, cap, ny_pad}; a tile is 4 x 28 cells from column 1 on
// (bgf::ring_tile: its window's first column is then 16-byte aligned, as a
// box's must be), its window a box {32, 1, rows + 2} per field at
// (col0 - 1, slot, row0 - 1), its references a box {32, 1, rows} at
// (col0 - 1, slot, row0), a box per slot below the tile's kmax (one box of
// cap slots stages up to cap / kmax more bytes and measured no faster).
// The grid is blocks-per-SM x SMs blocks walking the interior tiles with
// the grid's stride, after their consumers have written the ghost blocks'
// fills and ghost column 0 (x, y as they are, v = 0: K2's dead slots;
// column 0 holds no live slot).  The producer warp's first lane waits for
// the stage's "empty" barrier, arms its "full" barrier with the tile's
// bytes and issues the tile's boxes (a tile with kmax 0 is armed with 0
// bytes).  The consumer warps wait for the full barrier and, in one pass,
// repack the landed fields into K2's packed window outside the stage (bgf::repack_force_window: (x, y, vx, vy) as a
// float4, the EOS pair (p, 1/rho) as a float2 with the twin's float
// operations, FAR for the window column past the plane's last, which K2
// wraps to a ghost column, and the counts) and copy the references; then
// they release the stage, so the producer refills it while they run K2's
// pair listing, taps (bgf::tile_accel: K2's loads and float operations),
// epilogue (bgf::integrate), displacement max and dead-slot pass.  One max
// per block, at the end (the max does not depend on the order).  The
// packed window costs two shared loads a tap; the landed fields, one array
// each, would cost six (a first design tapped them and ran 2.4x K2).
// Eleven consumer warps and one producer, two blocks per SM
// (__launch_bounds__ caps the registers for them): 24 resident warps per
// SM.  2-row tiles at four blocks of five consumer warps (24 warps too)
// spilled at the 80 registers that leaves a thread and ran 9% slower
// (tools/torch_tile_study.py's t1_r2; PERF.md).

#include "bgf_common.cuh"
#include "bgf_tma.cuh"

namespace {

constexpr int kRows = 4;            // tile rows (x bgf::kRingCols columns)
constexpr int kW = kRows + 2;       // window rows
constexpr int kWarps = 11;          // consumer warps (+ one producer warp)
constexpr int kCons = 32 * kWarps;  // consumer threads
constexpr int kThreads = kCons + 32;
constexpr int kMinBlocks = 2;       // blocks per SM it is built for
constexpr int kWinFields = 5;       // x, y, vx, vy, rho
constexpr int kRefFields = 2;       // ref_x, ref_y
static_assert(kWarps <= bgf::kMaxWarps, "a warp maximum per consumer warp");

struct Maps {
  CUtensorMap win[kWinFields];
  CUtensorMap ref[kRefFields];
};

// Floats of one window field and of one reference field in the stage.
__host__ __device__ __forceinline__ int win_floats(int cap) {
  return kW * cap * bgf::kWinCols;
}
__host__ __device__ __forceinline__ int ref_floats(int cap) {
  return kRows * cap * bgf::kWinCols;
}
__host__ __device__ __forceinline__ int stage_floats(int cap) {
  return kWinFields * win_floats(cap) + kRefFields * ref_floats(cap);
}

// Dynamic shared memory: the stage, then the packed (x, y, vx, vy) and
// (p, 1/rho) windows, the (ref_x, ref_y) tile, the window counts, the pair
// list and its count (models/exp_kernels.dbuf_plan mirrors it).
int dbuf_smem(int cap) {
  return bgf::stage_smem_bytes(
      stage_floats(cap) * 4,
      win_floats(cap) * (16 + 8) + ref_floats(cap) * 8 +
          kW * bgf::kWinCols * 4 + (kRows * bgf::kRingCols * cap + 1) * 4);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dbuf_kernel(__grid_constant__ const Maps maps,
                const float* __restrict__ x, const float* __restrict__ y,
                const int* __restrict__ occ, float* __restrict__ ox,
                float* __restrict__ oy, float* __restrict__ ovx,
                float* __restrict__ ovy, unsigned int* __restrict__ disp_bits,
                int cap, int ny_pad, int nx_pad, int tb, int nb,
                bgf::ForceConsts fc, float rho0, float k,
                bgf::IntegrateConsts ic) {
  using namespace bgf;
  // a landed field's slot (wr, kj, wc) at (kj * kW + wr) * 32 + wc, a
  // landed reference's (tr, s, c) at (s * kRows + tr) * 32 + c: a box per
  // slot
  const int win = win_floats(cap);
  const int ref = ref_floats(cap);
  extern __shared__ unsigned char smem_raw[];
  const StageSmem sm = stage_smem(smem_raw, stage_floats(cap));
  stage_init(sm);

  const int per_rb = ((tb + kRows - 1) / kRows) * ring_tiles_x(nx_pad);
  const int n_tiles = nb * per_rb;  // interior tiles, from row block 1 on

  if (threadIdx.x >= kCons) {  // the producer warp
    if (threadIdx.x != kCons) return;
    for (int f = 0; f < kWinFields; ++f) prefetch_tensormap(&maps.win[f]);
    for (int f = 0; f < kRefFields; ++f) prefetch_tensormap(&maps.ref[f]);
    constexpr uint32_t kSlotBytes =
        (kWinFields * kW + kRefFields * kRows) * kWinCols * 4;
    int i = 0;
    for (int b = blockIdx.x; b < n_tiles; b += gridDim.x, ++i) {
      mbar_wait(sm.empty, (i & 1) ^ 1);
      const Tile t = ring_tile(b + per_rb, nx_pad, tb, kRows);
      const int kmax = block_kmax(occ, nb, t.rb - 1);
      mbar_arrive_expect_tx(sm.full, kmax * kSlotBytes);
      for (int j = 0; j < kmax; ++j) {
        for (int f = 0; f < kWinFields; ++f)
          tma_load_3d(sm.stage + f * win + j * kW * kWinCols, &maps.win[f],
                      sm.full, t.col0 - 1, j, t.row0 - 1);
        for (int f = 0; f < kRefFields; ++f)
          tma_load_3d(sm.stage + kWinFields * win + f * ref +
                          j * kRows * kWinCols,
                      &maps.ref[f], sm.full, t.col0 - 1, j, t.row0);
      }
    }
    return;
  }

  float4* pwin = reinterpret_cast<float4*>(sm.tail);
  float2* eos = reinterpret_cast<float2*>(pwin + win);
  float2* refs = eos + win;  // tile slot (tr, s, tc) at (tr * kmax + s) * 32
  int* cnt = reinterpret_cast<int*>(refs + ref);
  int* pairs = cnt + kW * kWinCols;
  int* n_pairs = pairs + kRows * kRingCols * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // K2's fills of the ghost blocks (FAR, zero velocity) and of ghost column
  // 0, in no tile (x and y as they are, zero velocity: its slots are dead)
  const long long half = static_cast<long long>(tb) * cap * nx_pad;
  const long long n_col0 = static_cast<long long>(nb) * tb * cap;
  for (long long e = static_cast<long long>(blockIdx.x) * kCons + threadIdx.x;
       e < 2 * half + n_col0; e += static_cast<long long>(gridDim.x) * kCons) {
    if (e < 2 * half) {
      const long long g =
          e < half ? e : e - half + static_cast<long long>(nb + 1) * half;
      ox[g] = kFar;
      oy[g] = kFar;
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
    } else {  // (row, slot) layer tb * cap + q, column 0
      const long long g =
          (static_cast<long long>(tb) * cap + e - 2 * half) * nx_pad;
      ox[g] = x[g];
      oy[g] = y[g];
      ovx[g] = 0.0f;
      ovy[g] = 0.0f;
    }
  }

  float d2 = 0.0f;
  int i = 0;
  for (int b = blockIdx.x; b < n_tiles; b += gridDim.x, ++i) {
    const Tile t = ring_tile(b + per_rb, nx_pad, tb, kRows);
    const int kmax = block_kmax(occ, nb, t.rb - 1);
    mbar_wait(sm.full, i & 1);
    repack_force_window<kCons, kW>(t, kmax, nx_pad, sm.stage, win, rho0, k,
                                   pwin, eos, cnt);
    const float* RX = sm.stage + kWinFields * win;
    for (int c = threadIdx.x; c < kRows * kWinCols; c += kCons) {
      const int tr = c / kWinCols;
      const int tc = c - tr * kWinCols;
      if (tr >= t.rows || tc >= t.cols) continue;
      for (int s = 0; s < kmax; ++s) {
        // the box starts at col0 - 1
        const int r = (s * kRows + tr) * kWinCols + tc + 1;
        refs[(tr * kmax + s) * kWinCols + tc] =
            make_float2(RX[r], RX[ref + r]);
      }
    }
    consumer_sync(kCons);  // the stage is read: the producer may refill it
    if (threadIdx.x == 0) mbar_arrive(sm.empty);
    if (warp == 0)
      list_region<kRows>(t.rows, t.cols, 1, kRingCols, kmax, cnt, pairs,
                         n_pairs);
    consumer_sync(kCons);

    // K2's taps, epilogue and displacement
    const int np = *n_pairs;
    const int rs = kmax * kWinCols;  // window row stride
    for (int p = threadIdx.x; p < np; p += kCons) {
      const int cell = pairs[p] >> 8;
      const int s = pairs[p] & 255;
      const int tr = cell / kRingCols;
      const int tc = cell - tr * kRingCols;
      const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
      const float4 own = pwin[own_i];
      const float2 a = tile_accel(pwin, eos, tr * rs + tc, rs,
                                  neighbour_counts(cnt, tr, tc).x, own,
                                  eos[own_i].x, fc);
      float nx, ny, nvx, nvy;
      const bool live = integrate(own.x, own.y, own.z, own.w, a.x, a.y, ic,
                                  nx, ny, nvx, nvy);
      const long long g =
          (static_cast<long long>(t.row0 + tr) * cap + s) * nx_pad + t.col0 +
          tc;
      ox[g] = nx;
      oy[g] = ny;
      ovx[g] = nvx;
      ovy[g] = nvy;
      if (live) {
        const float2 r = refs[(tr * kmax + s) * kWinCols + tc];
        const float drx = nx - r.x;
        const float dry = ny - r.y;
        d2 = fmaxf(d2, __fadd_rn(__fmul_rn(drx, drx), __fmul_rn(dry, dry)));
      }
    }
    // dead slots: x and y as they are (FAR past kmax), zero velocity
    if (lane < t.cols)
      for (int tr = 0; tr < t.rows; ++tr)
        for (int s = warp; s < cap; s += kWarps)
          if (s >= cnt[(tr + 1) * kWinCols + lane + 1]) {
            const float4 v =
                s < kmax ? pwin[(tr + 1) * rs + s * kWinCols + lane + 1]
                         : make_float4(kFar, kFar, 0.0f, 0.0f);
            const long long g =
                (static_cast<long long>(t.row0 + tr) * cap + s) * nx_pad +
                t.col0 + lane;
            ox[g] = v.x;
            oy[g] = v.y;
            ovx[g] = 0.0f;
            ovy[g] = 0.0f;
          }
    consumer_sync(kCons);  // the window and the lists are read
  }
  consumer_max_atomic(d2, kWarps, sm.warp_max, disp_bits);
}

// The kernel at cap slots: its shared-memory limit raised to its dynamic
// shared memory, and the card checked to hold kMinBlocks of its blocks
// per SM.
cudaError_t ready(int cap, int* smem) {
  *smem = dbuf_smem(cap);
  return bgf::check_blocks(dbuf_kernel, kThreads, *smem, kMinBlocks);
}

}  // namespace

// The arguments of bgf_forces_integrate's ref-based form (every lane in
// the displacement max).  Returns 0, a cudaError_t, or bgf::kEncodeError +
// the driver's CUresult when a tensor map was refused.
extern "C" int bgf_forces_integrate_dbuf(
    const float* x, const float* y, const float* vx, const float* vy,
    const float* rho, const float* ref_x, const float* ref_y, const int* occ,
    float* ox, float* oy, float* ovx, float* ovy, float* disp, int ny_pad,
    int cap, int nx_pad, int tb, int nb, float h, float m_half,
    float spiky_c, float visc_mc, float rho0, float k, float dt, float x_min,
    float x_max, float bounce, float floor_y, cudaStream_t stream) {
  int smem = 0;
  unsigned blocks = 0;
  cudaError_t err = ready(cap, &smem);
  if (err == cudaSuccess)
    err = bgf::persistent_grid(
        kMinBlocks,
        static_cast<long long>(nb) * ((tb + kRows - 1) / kRows) *
            bgf::ring_tiles_x(nx_pad),
        &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each plane [ny_pad, cap, nx_pad] as dims {nx_pad, cap, ny_pad}
  const long long dims[3] = {nx_pad, cap, ny_pad};
  const long long strides[2] = {4LL * nx_pad, 4LL * cap * nx_pad};
  const int box[3] = {bgf::kWinCols, 1, kW};
  const int ref_box[3] = {bgf::kWinCols, 1, kRows};
  Maps maps;
  const float* win[kWinFields] = {x, y, vx, vy, rho};
  const float* ref[kRefFields] = {ref_x, ref_y};
  for (int f = 0; f < kWinFields; ++f) {
    const int e = bgf::encode_map_3d(&maps.win[f], win[f], dims, strides, box);
    if (e != 0) return e;
  }
  for (int f = 0; f < kRefFields; ++f) {
    const int e =
        bgf::encode_map_3d(&maps.ref[f], ref[f], dims, strides, ref_box);
    if (e != 0) return e;
  }
  err = cudaMemsetAsync(disp, 0, sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dbuf_kernel<<<blocks, kThreads, smem, stream>>>(
      maps, x, y, occ, ox, oy, ovx, ovy,
      reinterpret_cast<unsigned int*>(disp), cap, ny_pad, nx_pad, tb, nb,
      bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, rho0, k,
      bgf::IntegrateConsts{dt, x_min, x_max, bounce, floor_y});
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes at slot capacity cap, into out[0..4].
extern "C" int bgf_forces_integrate_dbuf_occupancy(int cap, int* out) {
  return bgf::report_occupancy(dbuf_kernel, kThreads, dbuf_smem(cap), out);
}

// The persistent grid at slot capacity cap: kMinBlocks x the current
// device's SMs, into out[0], once the card is checked to hold them.
extern "C" int bgf_forces_integrate_dbuf_grid(int cap, int* out) {
  int smem = 0, sms = 0;
  cudaError_t err = ready(cap, &smem);
  if (err == cudaSuccess) err = bgf::sm_count(&sms);
  out[0] = kMinBlocks * sms;
  return static_cast<int>(err);
}
