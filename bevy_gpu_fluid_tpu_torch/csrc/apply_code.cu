// K7: the planar rebin's copy pass ("apply"): one payload plane routed
// through K6's code plane.
//
// Replaces the TPU kernel `_apply_kernel` / `apply_code_pallas`
// (bevy_gpu_fluid_tpu/ops/reslot.py:504, :534).  For each output slot
// (row, k, col) of an interior row with code c >= 0, c = kj * 9 + (dx + 1)
// * 3 + (dy + 1) names the source slot (row + dy, kj, col + dx), the column
// wrapping modulo nx_pad like the TPU lane roll; the output takes the
// payload there.  A slot with c = -1, a code naming a source slot at or
// past the row block's bound kmax (the TPU kernel's loop never reaches
// it), and the ghost blocks get `fill`.  The TPU kernel tests all 9 x kmax
// candidates per slot with a compare and select; here the code is decoded
// and the one source slot it names is read.
//
// The payload only moves, so the kernel copies 32-bit words: one kernel
// serves float32 and int32 planes, given the fill's bits.  The code plane
// is int32 or int8.  The output is a new plane or a dead plane the caller
// gives (the TPU kernel's `out`), written in full and never read; it reads
// a +-1-row halo of its payload, so the output never overlaps its own input
// (the wrapper refuses such an `out`).
//
// What bounds it on the H100: device memory.  It reads the payload and the
// code and writes one plane: at the 1M-particle shapes [696, 8, 640],
// 14.3 MB x 3 (int32 code) = 42.8 MB, ~0.013 ms at 3.35 TB/s per apply;
// the rebin runs five.
// Design: one thread per output slot, threads along nx_pad: code and output
// accesses coalesce; the payload gather reads slots of the 3 x 3
// neighbourhood, which neighbouring threads share.

#include <cstdint>

#include "bgf_common.cuh"

namespace {

template <typename Code>
__global__ void apply_code_kernel(const uint32_t* __restrict__ payload,
                                  const Code* __restrict__ code,
                                  const int* __restrict__ occ,
                                  uint32_t* __restrict__ out, int cap,
                                  int nx_pad, int tb, int nb, long long total,
                                  uint32_t fill) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= total) return;
  const int col = static_cast<int>(t % nx_pad);
  const int row = static_cast<int>(t / nx_pad / cap);
  uint32_t v = fill;
  if (bgf::interior_row(row, tb, nb)) {
    const int c = static_cast<int>(code[t]);
    if (c >= 0) {
      const int kj = c / 9;
      const int r = c - kj * 9;
      const int dx = r / 3 - 1;
      const int dy = r - (dx + 1) * 3 - 1;
      if (kj < bgf::block_kmax(occ, nb, row / tb - 1)) {
        const long long j = (static_cast<long long>(row + dy) * cap + kj) *
                                nx_pad +
                            bgf::wrap_col(col + dx, nx_pad);
        v = payload[j];
      }
    }
  }
  out[t] = v;
}

}  // namespace

// payload and out: 32-bit words (float32 or int32 planes); fill_bits: the
// fill's bit pattern; code_bytes: 4 (int32 code) or 1 (int8); any other
// value returns cudaErrorInvalidValue without launching.
extern "C" int bgf_apply_code(const void* payload, const void* code,
                              const int* occ, void* out, int ny_pad, int cap,
                              int nx_pad, int tb, int nb, int code_bytes,
                              int fill_bits, cudaStream_t stream) {
  const long long total = static_cast<long long>(ny_pad) * cap * nx_pad;
  const unsigned blocks = bgf::blocks_for(total);
  const auto* p = static_cast<const uint32_t*>(payload);
  auto* o = static_cast<uint32_t*>(out);
  const auto fill = static_cast<uint32_t>(fill_bits);
  if (code_bytes == 4) {
    apply_code_kernel<int32_t><<<blocks, bgf::kThreads, 0, stream>>>(
        p, static_cast<const int32_t*>(code), occ, o, cap, nx_pad, tb, nb,
        total, fill);
  } else if (code_bytes == 1) {
    apply_code_kernel<int8_t><<<blocks, bgf::kThreads, 0, stream>>>(
        p, static_cast<const int8_t*>(code), occ, o, cap, nx_pad, tb, nb,
        total, fill);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
