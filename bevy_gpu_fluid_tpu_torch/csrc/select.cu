// K6: the planar rebin's routing pass ("select").
//
// Replaces the TPU kernel `_select_kernel` / `select_pallas`
// (bevy_gpu_fluid_tpu/ops/reslot.py:393, :455), single-chip clip.  It is
// K3's candidate scan (bgf::scan_candidates, the same code as reslot.cu, so
// the slot assignment is bitwise K3's) without the payload moves: for the
// n-th match of a target cell it writes the candidate's routing code
// kj * 9 + (dx + 1) * 3 + (dy + 1) into output slot n, -1 into the slots
// no match reaches, and the match count into the per-cell count plane.
// The code plane is int32 or int8 (the caller's choice; codes span
// [-1, 72)); the launch covers the ghost blocks, which get -1 and a zero
// count.  K7 (apply_code.cu) then routes each payload plane through it.
//
// What bounds it on the H100: device memory.  It reads x and y and writes
// the code plane and the counts: at the 1M-particle shapes [696, 8, 640],
// 28.5 MB + 14.3 MB (int32 code) + 1.8 MB, ~0.013 ms at 3.35 TB/s.  The
// candidate taps re-read x/y of the 3x3 neighbourhood from L1/L2, as K3.
// Design: K3's, one thread per target cell along nx_pad with the running
// count in a register; the code store is the only write per match.

#include <cstdint>

#include "bgf_common.cuh"

namespace {

template <typename Code>
__global__ void select_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const int* __restrict__ occ,
                              Code* __restrict__ code, int* __restrict__ cnt,
                              int cap, int nx_pad, int tb, int nb,
                              long long n_cells, bgf::CellGrid g) {
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
        g, [&](int rank, long long, int c) {
          code[out0 + static_cast<long long>(rank) * nx_pad] =
              static_cast<Code>(c);
        });
  }
  for (int s = min(count, cap); s < cap; ++s)
    code[out0 + static_cast<long long>(s) * nx_pad] = static_cast<Code>(-1);
  cnt[t] = count;
}

}  // namespace

// code_bytes: 4 for an int32 code plane, 1 for int8; any other value
// returns cudaErrorInvalidValue without launching.
extern "C" int bgf_select(const float* x, const float* y, const int* occ,
                          void* code, int* cnt, int ny_pad, int cap,
                          int nx_pad, int tb, int nb, int row0, int nx,
                          int ny, int code_bytes, float origin_x,
                          float origin_y, float inv, cudaStream_t stream) {
  const long long n_cells = static_cast<long long>(ny_pad) * nx_pad;
  const bgf::CellGrid g{nx, ny, row0, origin_x, origin_y, inv};
  const unsigned blocks = bgf::blocks_for(n_cells);
  if (code_bytes == 4) {
    select_kernel<int32_t><<<blocks, bgf::kThreads, 0, stream>>>(
        x, y, occ, static_cast<int32_t*>(code), cnt, cap, nx_pad, tb, nb,
        n_cells, g);
  } else if (code_bytes == 1) {
    select_kernel<int8_t><<<blocks, bgf::kThreads, 0, stream>>>(
        x, y, occ, static_cast<int8_t*>(code), cnt, cap, nx_pad, tb, nb,
        n_cells, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
