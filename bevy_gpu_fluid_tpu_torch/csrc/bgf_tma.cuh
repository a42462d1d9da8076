// Hopper's bulk tensor copies (TMA) and the shared-memory barriers that
// report them (mbarrier), for the kernels that stage a window ahead of
// their compute: the staged-ahead fused step (exp_dbuf.cu) and the
// slot-major forces (exp_tlayout.cu).
//
// A tensor map describes a float32 plane as a 3D tensor and the box one
// copy moves; the host encodes it with the driver's cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so the library links
// no libcuda.  The kernel takes its maps as __grid_constant__ parameters.
// One thread issues a box; the copy engine writes it into shared memory and
// counts its bytes against a "full" mbarrier that the issuing thread armed
// with the stage's byte count (arrive.expect_tx).  An element of a box past
// the tensor's edge lands as 0 (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), never
// FAR: the kernels take a window column there as FAR when they repack it.
//
// What the card holds a box to (measured on the H100: a violation faults
// with "illegal instruction" or "misaligned address"): its first element
// 16-byte aligned in the plane, so its first column a multiple of 4, and
// its shared-memory destination 128-byte aligned.
//
// One stage, reused by every tile of a block's walk (a deeper ring
// measured no faster on the H100: PERF.md): a "full" and an "empty"
// barrier of one arrival each.  A barrier completes one phase per tile, so
// the consumers of the block's i-th tile wait on the full barrier for
// phase parity i & 1, and the producer waits on the empty one with the
// opposite parity, which passes at once for the first tile.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bgf_common.cuh"

namespace bgf {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises a barrier for `count` arrivals; the fence makes
// the initialisation visible to the copy engine, and a block-wide sync
// after it to the other threads.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and expects `bytes` more of copies before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (c0, c1, c2) of `map` (innermost coordinate first) into dst, its
// bytes counted against bar.  dst is 128-byte aligned.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A barrier of the first `threads` threads of the block (the consumer
// warps), leaving the producer warp out.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---- the staged kernels' tiles and shared memory

// A staged kernel's tile: rows x kRingCols cells of one row block, its
// window the tile and a one-cell ring, 32 columns (kWinCols) wide, as the
// halo tile of bgf_common.cuh.  The tiles start at column 1 (col0 = 1 +
// 28 t), so a window's first column, col0 - 1, is a multiple of 4: a box's
// first element must be 16-byte aligned (measured on the H100: an
// unaligned one faults with "illegal instruction", and so does a 30-column
// tile's window, which starts at 30 t - 1).  Column 0, a ghost column, lies
// in no tile: the kernels write its outputs in their ghost pass.
constexpr int kRingCols = 28;

__host__ __device__ __forceinline__ int ring_tiles_x(int nx_pad) {
  return (nx_pad - 1 + kRingCols - 1) / kRingCols;
}

// Tile b of a staged kernel with `rows`-row tiles (row-block major, then
// tile row, then tile column), over all ny_pad rows.
__device__ __forceinline__ Tile ring_tile(int b, int nx_pad, int tb,
                                          int rows) {
  const int tiles_x = ring_tiles_x(nx_pad);
  const int per_rb = (tb + rows - 1) / rows;
  const int ty = b / tiles_x;
  Tile t;
  t.col0 = 1 + (b - ty * tiles_x) * kRingCols;
  t.cols = min(kRingCols, nx_pad - t.col0);
  t.rb = ty / per_rb;
  const int r_in = (ty - t.rb * per_rb) * rows;
  t.row0 = t.rb * tb + r_in;
  t.rows = min(rows, tb - r_in);
  return t;
}

constexpr int kSmemAlign = 128;    // TMA's shared-memory alignment
constexpr int kMaxWarps = 32;      // consumer warps a staged kernel may have
constexpr int kHeaderBytes = 256;  // the two barriers, kMaxWarps maxima

// Dynamic shared memory of a staged kernel: alignment slack, the header,
// the stage and the kernel's own buffers after it (tail_bytes).
__host__ __device__ __forceinline__ int stage_smem_bytes(int stage_bytes,
                                                         int tail_bytes) {
  return kSmemAlign + kHeaderBytes + stage_bytes + tail_bytes;
}

struct StageSmem {
  uint64_t* full;       // the stage's boxes have landed
  uint64_t* empty;      // the consumers have read the stage
  float* warp_max;      // [kMaxWarps]
  float* stage;         // stage_floats
  unsigned char* tail;  // the kernel's own buffers, 128-byte aligned
};

__device__ __forceinline__ StageSmem stage_smem(unsigned char* raw,
                                                int stage_floats) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + kSmemAlign - 1) &
      ~static_cast<uintptr_t>(kSmemAlign - 1));
  StageSmem s;
  s.full = reinterpret_cast<uint64_t*>(base);
  s.empty = s.full + 1;
  s.warp_max = reinterpret_cast<float*>(base + 128);
  s.stage = reinterpret_cast<float*>(base + kHeaderBytes);
  s.tail = reinterpret_cast<unsigned char*>(s.stage + stage_floats);
  return s;
}

// Initialises the stage's barriers (one arrival each) and syncs the block.
__device__ __forceinline__ void stage_init(const StageSmem& sm) {
  if (threadIdx.x == 0) {
    mbar_init(sm.full, 1);
    mbar_init(sm.empty, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// The force window of a tile from a landed stage, in K2's packed layout
// (bgf::stage_force_window's): window slot (wr, kj, wc), kj < kmax, at
// (wr * kmax + kj) * kWinCols + wc gets (x, y, vx, vy) into win and the
// EOS pair (p, 1/rho) into eos with the twin's float operations; FAR and
// zeros past the tile's ring, and FAR for a window column past the plane's
// last (the box filled it with 0; K2 wraps it to ghost column 0, FAR with
// v = 0); each window cell's live prefix below kmax into cnt.  The stage
// holds a box per field and slot, field f's slot (wr, kj, wc) at f * field
// + (kj * kW + wr) * kWinCols + wc.  Consumer threads (kCons of them)
// only.
template <int kCons, int kW>
__device__ __forceinline__ void repack_force_window(
    const Tile& t, int kmax, int nx_pad, const float* S, int field,
    float rho0, float k, float4* win, float2* eos, int* cnt) {
  for (int c = threadIdx.x; c < kW * kWinCols; c += kCons) {
    const int wr = c / kWinCols;
    const int wc = c - wr * kWinCols;
    const bool in = wr < t.rows + 2 && wc < t.cols + 2;
    const bool edge = t.col0 - 1 + wc >= nx_pad;
    int n = 0;
    for (int kj = 0; kj < kmax; ++kj) {
      const int i = (wr * kmax + kj) * kWinCols + wc;
      const int g = (kj * kW + wr) * kWinCols + wc;
      if (!in || edge) {
        win[i] = make_float4(kFar, kFar, 0.0f, 0.0f);
        eos[i] = make_float2(0.0f, 0.0f);
        continue;
      }
      const float xg = S[g];
      const float rg = S[4 * field + g];
      win[i] = make_float4(xg, S[field + g], S[2 * field + g],
                           S[3 * field + g]);
      eos[i] = make_float2(k * fmaxf(rg - rho0, 0.0f),
                           1.0f / fmaxf(rg, 1.0e-12f));
      n += n == kj && xg < kHalfFar;
    }
    cnt[c] = n;
  }
}

// Max of d2 >= 0 over the consumer warps (`warps` of them; every consumer
// thread calls it), then one atomicMax on the float bits into *bits.
__device__ __forceinline__ void consumer_max_atomic(float d2, int warps,
                                                    float* warp_max,
                                                    unsigned int* bits) {
  for (int off = 16; off > 0; off >>= 1)
    d2 = fmaxf(d2, __shfl_xor_sync(0xffffffffu, d2, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = d2;
  consumer_sync(32 * warps);
  if (warp == 0) {
    float v = lane < warps ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const unsigned int b = __float_as_uint(v);
    if (lane == 0 && b != 0u) atomicMax(bits, b);
  }
}

// ---- host side

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The persistent grid over `tiles` interior tiles: `per_sm` blocks per
// SM x the device's SMs, at most a block per tile.
inline cudaError_t persistent_grid(int per_sm, long long tiles,
                                   unsigned* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  const long long n = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<unsigned>(n < tiles ? n : tiles);
  return err;
}

// Raises the kernel's shared-memory limit to smem and checks that the
// current device holds `blocks` of its blocks per SM (the occupancy the
// kernel is built for): cudaErrorInvalidConfiguration if not.
template <class Kernel>
cudaError_t check_blocks(Kernel kernel, int threads, int smem, int blocks) {
  int per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && per_sm < blocks)
    err = cudaErrorInvalidConfiguration;
  return err;
}

// What a C entry point returns when the driver refused a tensor map: this
// plus the driver's CUresult (cudaError_t codes stay below it).
constexpr int kEncodeError = 100000;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
inline int encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return 0;
}

// A float32 3D tensor map over `base`: dims innermost first (elements),
// the byte strides of dims 1 and 2, the box extents.  0, a cudaError_t, or
// kEncodeError + the driver's CUresult.
inline int encode_map_3d(CUtensorMap* map, const float* base,
                         const long long dims[3], const long long strides[2],
                         const int box[3]) {
  EncodeTiledFn fn = nullptr;
  const int err = encode_tiled_fn(&fn);
  if (err != 0) return err;
  const cuuint64_t d[3] = {static_cast<cuuint64_t>(dims[0]),
                           static_cast<cuuint64_t>(dims[1]),
                           static_cast<cuuint64_t>(dims[2])};
  const cuuint64_t s[2] = {static_cast<cuuint64_t>(strides[0]),
                           static_cast<cuuint64_t>(strides[1])};
  const cuuint32_t b[3] = {static_cast<cuuint32_t>(box[0]),
                           static_cast<cuuint32_t>(box[1]),
                           static_cast<cuuint32_t>(box[2])};
  const cuuint32_t e[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace bgf
