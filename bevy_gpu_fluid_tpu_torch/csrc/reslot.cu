// K3: sort-free local rebin ("reslot") of the dense slot grid.
//
// Replaces the TPU kernel `_reslot_kernel` / `reslot_pallas`
// (bevy_gpu_fluid_tpu/ops/reslot.py:203, :289), its x clip range and world
// origin taken as data (bgf::CellGrid): the single-chip [0, nx-1] and the
// grid's origin, or a slab's [-1, nx] and origin, which capture the particles
// that left the slab in its ghost columns.  Each target cell scans
// the 72 candidate slots of its 3x3 neighbourhood in (kj, dx, dy) order; a
// candidate matches when it is live (x < FAR/2) and its clipped cell
// floor((p - origin) * inv) equals the target.  The n-th match goes to
// output slot n (the Pallas kernel's one-hot select on rank == k); matches
// beyond cap are only counted.  Outputs: the five rebinned planes (x, y,
// vx, vy, idx; empty slots FAR/FAR/0/0/-1) and the per-cell match counts
// int32 [ny_pad, nx_pad].  The scan is bgf::scan_candidates, shared with
// K6 (select.cu); its cell arithmetic uses __fsub_rn/__fmul_rn and floorf so
// it rounds exactly as the PyTorch twin (ops/reslot.reslot_torch): the slot
// assignment is bitwise the twin's.
//
// What bounds it on the H100: device memory.  It moves 5 planes in, 5 out
// and the count plane with a few float and integer ops per candidate:
// 144 MB at the 1M-particle shapes [696, 8, 640], 0.043 ms at 3.35 TB/s,
// against 0.058 ms measured (H100 80GB HBM3, 700 W); it runs once per
// rebin.
// Design: one thread per target cell, threads along nx_pad (coalesced
// candidate reads; the kj bound is uniform across a warp).  The running
// count lives in a register, so the compaction needs no atomics and the
// within-cell order is deterministic.  The launch covers the ghost blocks,
// which get the empty fills and a zero count.

#include "bgf_common.cuh"

namespace {

__global__ void reslot_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int* __restrict__ idx, const int* __restrict__ occ,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ ovx,
    float* __restrict__ ovy, int* __restrict__ oidx, int* __restrict__ cnt,
    int cap, int nx_pad, int tb, int nb, long long n_cells,
    bgf::CellGrid g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n_cells) return;
  const int col = static_cast<int>(t % nx_pad);
  const int row = static_cast<int>(t / nx_pad);
  const long long out0 = static_cast<long long>(row) * cap * nx_pad + col;
  int count = 0;
  if (bgf::interior_row(row, tb, nb)) {
    count = bgf::scan_candidates(
        x, y, row, col, bgf::block_kmax(occ, nb, row / tb - 1), cap, nx_pad,
        g, [&](int rank, long long j, int) {
          const long long o = out0 + static_cast<long long>(rank) * nx_pad;
          ox[o] = x[j];
          oy[o] = y[j];
          ovx[o] = vx[j];
          ovy[o] = vy[j];
          oidx[o] = idx[j];
        });
  }
  for (int s = min(count, cap); s < cap; ++s) {
    const long long o = out0 + static_cast<long long>(s) * nx_pad;
    ox[o] = bgf::kFar;
    oy[o] = bgf::kFar;
    ovx[o] = 0.0f;
    ovy[o] = 0.0f;
    oidx[o] = -1;
  }
  cnt[t] = count;
}

}  // namespace

extern "C" int bgf_reslot(const float* x, const float* y, const float* vx,
                          const float* vy, const int* idx, const int* occ,
                          float* ox, float* oy, float* ovx, float* ovy,
                          int* oidx, int* cnt, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, int row0,
                          int clip_lo, int clip_hi, int ny, float origin_x,
                          float origin_y, float inv, cudaStream_t stream) {
  const long long n_cells = static_cast<long long>(ny_pad) * nx_pad;
  reslot_kernel<<<bgf::blocks_for(n_cells), bgf::kThreads, 0, stream>>>(
      x, y, vx, vy, idx, occ, ox, oy, ovx, ovy, oidx, cnt, cap, nx_pad, tb,
      nb, n_cells,
      bgf::CellGrid{ny, row0, clip_lo, clip_hi, origin_x, origin_y, inv});
  return static_cast<int>(cudaGetLastError());
}
