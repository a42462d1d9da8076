// T4: K8 with its pair arithmetic as a template parameter: the forces
// arithmetic variants of the reference's kernel experiment.
//
// Replaces the TPU kernel `_forces_kernel_v` / `make_forces(grid,
// variant)` (tools/exp_forces.py:47, :235; its pl.pallas_call :244).  Each
// variant computes K8's accelerations (csrc/forces.cu) with its TPU
// variant's float operations in order (exp_forces.py:108-221):
//   v0    K8's own arithmetic: bgf::add_pair_accel itself, so v0 is
//         bitwise K8;
//   v0nr  v0 with rsqrt(r^2 + EPS^2) replaced by r^2 + EPS (EPS = 1e-6):
//         wrong physics on purpose, it only prices the rsqrt;
//   v1    constants folded, C1 = (-m/2) spiky_c, C2 = mu m visc_c, and
//         u = (p_i + p_j) / rho_j: fac_p = (C1 u)(hr^2 inv_r),
//         fac_v = (C2 hr) / rho_j;
//   v2    v1 with v_i factored out: a third sum sv of fac_v, and
//         a_i -= v_i sv once after the loop;
//   v3    v2 with the slot-layer loop unrolled by two (bgf::walk_taps2):
//         an odd bound's last layer goes alone, so v3 adds v2's terms in
//         v2's order and is bitwise v2.
//
// What bounds it on the H100: K8's bytes (7 planes).  Its first form (K8's
// halo tile, 4-byte staging through registers from an unaligned window, a
// thread per live slot tapping 9 x the largest count of its 9 cells) ran
// at 37-39% of that bound on the 1M planes: its staging at 61% of what its
// bytes allow and every tap paying its own two shared loads.
//
// Design: the walk tile of bgf_walk.cuh.  4 x 28-cell tiles from column 1
// (bgf::ring_tile), so a window row of one slot layer is eight aligned
// 16-byte chunks: a warp per window row, its lanes four slot layers of the
// eight chunks at a time, loads x, y, vx, vy and rho as float4s, packs
// (x, y, vx, vy) as a float4 and the EOS pair (p, 1/rho) as a float2 with
// K8's float operations (so they are the bits K8 uses), stores them into
// the column-major window and counts each column's live prefix in the same
// pass.  Warp 0 lists the items (cell, slot pair); a thread per item taps
// K8's candidates (every one below the largest of its cell's 9 counts, in
// (kj, dx, dy) order), each loaded once for both slots' sums, so v0 is K8
// bit for bit and v3 v2.  Dead slots are +0 from the counts, ghost blocks
// and plane column 0 +0.  256 threads a block.  Timings, occupancy and
// the designs tried are in PERF.md (chip_smoke.py phase 20 and
// tools/torch_tile_study.py).

#include "bgf_walk.cuh"

namespace {

using G = bgf::WalkTile<4, 7>;   // tile rows, window column stride
constexpr int kBlock = 256;
constexpr int kSlots = 2;        // slots a thread (1: K8's thread per slot)
enum Variant : int { kV0 = 0, kV0nr = 1, kV1 = 2, kV2 = 3, kV3 = 4 };
constexpr float kEpsNr = 1.0e-6f;  // v0nr's r^2 + EPS

struct VariantConsts {
  bgf::ForceConsts fc;  // h, -m/2, spiky_c, mu m visc_c (= C2)
  float c1;             // (-m/2) spiky_c
};

// Dynamic shared memory: the (x, y, vx, vy) and (p, 1/rho) windows at cap
// slot layers, the window counts, the items and their count
// (models/exp_kernels.walk_plan mirrors it).
int forces_variant_smem(int cap) {
  return G::win_slots(cap) * (16 + 8) + G::kWinRows * bgf::kWinCols * 4 +
         bgf::item_slots<G, kSlots>(cap) * 2 + 4;
}

// Slot j's term on slot i (own: i's x, y, vx, vy) into (ax, ay) and, for
// v2 and v3, sv.  p_sum = p_i + p_j.
template <int V>
__device__ __forceinline__ void pair_term(float ddx, float ddy, float p_sum,
                                          float ir_j, float vx_j, float vy_j,
                                          const float4& own,
                                          const VariantConsts& c, float& ax,
                                          float& ay, float& sv) {
  if (V == kV0) {
    bgf::add_pair_accel(ddx, ddy, p_sum, ir_j, vx_j - own.z, vy_j - own.w,
                        c.fc, ax, ay);
  } else if (V == kV0nr) {
    const float r2 = ddx * ddx + ddy * ddy;
    const float inv_r = r2 + kEpsNr;
    const float dist = r2 * inv_r;
    const float hr = fmaxf(c.fc.h - dist, 0.0f);
    const float fac_p =
        c.fc.m_half * p_sum * ir_j * (c.fc.spiky_c * hr * hr * inv_r);
    const float fac_v = c.fc.visc_mc * ir_j * hr;
    ax += fac_p * ddx + fac_v * (vx_j - own.z);
    ay += fac_p * ddy + fac_v * (vy_j - own.w);
  } else {
    const float r2 = ddx * ddx + ddy * ddy;
    const float inv_r = rsqrtf(r2 + bgf::kEps2);
    const float hr = fmaxf(c.fc.h - r2 * inv_r, 0.0f);
    const float u = p_sum * ir_j;
    const float fac_p = (c.c1 * u) * (hr * hr * inv_r);
    const float fac_v = (c.fc.visc_mc * hr) * ir_j;
    if (V == kV1) {
      ax += fac_p * ddx + fac_v * (vx_j - own.z);
      ay += fac_p * ddy + fac_v * (vy_j - own.w);
    } else {
      ax += fac_p * ddx + fac_v * vx_j;
      ay += fac_p * ddy + fac_v * vy_j;
      sv += fac_v;
    }
  }
}

// A force slot of a thread: its (x, y, vx, vy), its pressure and its sums.
struct Own {
  float4 v;
  float p;
  float ax = 0.0f, ay = 0.0f, sv = 0.0f;
};

template <int V>
__device__ __forceinline__ void tap(Own& o, const float4& w, const float2& e,
                                    const VariantConsts& c) {
  constexpr int kTap = V == kV3 ? kV2 : V;
  pair_term<kTap>(o.v.x - w.x, o.v.y - w.y, o.p + e.x, e.y, w.z, w.w, o.v, c,
                  o.ax, o.ay, o.sv);
}

// The accelerations of a slot once its taps are summed (v2, v3: a_i -=
// v_i sv).
template <int V>
__device__ __forceinline__ float2 accel(const Own& o) {
  if (V == kV2 || V == kV3)
    return make_float2(o.ax - o.v.z * o.sv, o.ay - o.v.w * o.sv);
  return make_float2(o.ax, o.ay);
}

template <int V>
__global__ void __launch_bounds__(kBlock) forces_variant_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const int* __restrict__ occ,
    float* __restrict__ ax_out, float* __restrict__ ay_out, int cap,
    int nx_pad, int tb, int nb, VariantConsts c, float rho0, float k) {
  using namespace bgf;
  const Tile t = ring_tile(blockIdx.x, nx_pad, tb, G::kRows);
  // plane offset of window slot (0, 0, 0): row row0 - 1, column col0 - 1
  const long long base =
      static_cast<long long>(t.row0 - 1) * cap * nx_pad + t.col0 - 1;
  const auto out_at = [&](int tr, int s, int wc) {
    return base + (static_cast<long long>(tr + 1) * cap + s) * nx_pad + wc;
  };
  if (t.rb == 0 || t.rb == nb + 1) {
    for_walk_slots<kBlock>(t, cap, [&](int tr, int s, int wc) {
      ax_out[out_at(tr, s, wc)] = 0.0f;
      ay_out[out_at(tr, s, wc)] = 0.0f;
    });
    return;
  }
  extern __shared__ float4 win[];  // G::kLayer x cap, column-major
  float2* eos = reinterpret_cast<float2*>(win + G::win_slots(cap));
  int* cnt = reinterpret_cast<int*>(eos + G::win_slots(cap));
  unsigned short* items =
      reinterpret_cast<unsigned short*>(cnt + G::kWinRows * kWinCols);
  int* n_items =
      reinterpret_cast<int*>(items + item_slots<G, kSlots>(cap));

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  stage_chunks<kBlock, G>(t, kmax, nx_pad, cnt,
                          [&](int kj, int wr, int q, bool in) {
    float4 xv = make_float4(kFar, kFar, kFar, kFar), yv = xv;
    float4 uv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), wv = uv, rv = uv;
    if (in) {
      const long long g =
          base + (static_cast<long long>(wr) * cap + kj) * nx_pad + 4 * q;
      xv = *reinterpret_cast<const float4*>(x + g);
      yv = *reinterpret_cast<const float4*>(y + g);
      uv = *reinterpret_cast<const float4*>(vx + g);
      wv = *reinterpret_cast<const float4*>(vy + g);
      rv = *reinterpret_cast<const float4*>(rho + g);
    }
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
    const float us[4] = {uv.x, uv.y, uv.z, uv.w};
    const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
    const float rs[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = G::at(kj, 4 * q + i, wr);
      win[j] = make_float4(xs[i], ys[i], us[i], ws[i]);
      eos[j] = in ? make_float2(k * fmaxf(rs[i] - rho0, 0.0f),
                                1.0f / fmaxf(rs[i], 1.0e-12f))
                  : make_float2(0.0f, 0.0f);
    }
    return xv;
  });
  __syncthreads();
  if (threadIdx.x < 32) list_items<G::kRows, kSlots>(t, kmax, cnt, items,
                                                      n_items);
  __syncthreads();

  const int n = *n_items;
  for (int p = threadIdx.x; p < n; p += kBlock) {
    const int cell = items[p] >> 6;
    const int s = items[p] & 63;
    const int tr = cell / kRingCols;
    const int tc = cell - tr * kRingCols;
    const int i0 = G::at(s, tc + 1, tr + 1);
    // the second slot when it is live, else a copy of the first (summed,
    // never written)
    const bool two = kSlots == 2 && s + 1 < cnt[(tr + 1) * kWinCols + tc + 1];
    const int i1 = two ? i0 + G::kLayer : i0;
    Own o0{win[i0], eos[i0].x};
    Own o1{win[i1], eos[i1].x};
    const auto taps = [&](int j) {
      const float4 w = win[j];
      const float2 e = eos[j];
      tap<V>(o0, w, e, c);
      if (kSlots == 2) tap<V>(o1, w, e, c);
    };
    const int b0 = G::at(0, tc, tr);
    if (V == kV3)
      walk_taps2<G::kLayer, G::kR>(cnt, tr, tc, b0, taps);
    else
      walk_taps<G::kLayer, G::kR>(cnt, tr, tc, b0, taps);
    const long long g = out_at(tr, s, tc + 1);
    const float2 a0 = accel<V>(o0);
    ax_out[g] = a0.x;
    ay_out[g] = a0.y;
    if (two) {
      const float2 a1 = accel<V>(o1);
      ax_out[g + nx_pad] = a1.x;
      ay_out[g + nx_pad] = a1.y;
    }
  }
  // dead slots, and plane column 0 (a ghost column: all its slots dead)
  for_walk_slots<kBlock>(t, cap, [&](int tr, int s, int wc) {
    if (wc == 0 || s >= cnt[(tr + 1) * kWinCols + wc]) {
      ax_out[out_at(tr, s, wc)] = 0.0f;
      ay_out[out_at(tr, s, wc)] = 0.0f;
    }
  });
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const int*, float*,
                          float*, int, int, int, int, VariantConsts, float,
                          float);

KernelFn kernel_of(int variant) {
  switch (variant) {
    case kV0: return forces_variant_kernel<kV0>;
    case kV0nr: return forces_variant_kernel<kV0nr>;
    case kV1: return forces_variant_kernel<kV1>;
    case kV2: return forces_variant_kernel<kV2>;
    case kV3: return forces_variant_kernel<kV3>;
    default: return nullptr;
  }
}

}  // namespace

// variant: 0 v0, 1 v0nr, 2 v1, 3 v2, 4 v3.  c1 = m_half * spiky_c.  Dense
// planes 16-byte aligned, nx_pad a multiple of 4, cap <= bgf::kMaxCap (the
// wrapper checks them; cudaErrorInvalidValue here otherwise).
extern "C" int bgf_forces_variant(const float* x, const float* y,
                                  const float* vx, const float* vy,
                                  const float* rho, const int* occ, float* ax,
                                  float* ay, int ny_pad, int cap, int nx_pad,
                                  int tb, int nb, int variant, float h,
                                  float m_half, float spiky_c, float visc_mc,
                                  float c1, float rho0, float k,
                                  cudaStream_t stream) {
  const KernelFn kernel = kernel_of(variant);
  if (kernel == nullptr || cap > bgf::kMaxCap || nx_pad % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = forces_variant_smem(cap);
  const cudaError_t err = bgf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bgf::walk_tiles(ny_pad, nx_pad, tb, G::kRows), kBlock, smem,
           stream>>>(
      x, y, vx, vy, rho, occ, ax, ay, cap, nx_pad, tb, nb,
      VariantConsts{bgf::ForceConsts{h, m_half, spiky_c, visc_mc}, c1}, rho0,
      k);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static and dynamic shared memory per block, blocks per SM and
// spill bytes of the variant's kernel at slot capacity cap, into out[0..4].
extern "C" int bgf_forces_variant_occupancy(int cap, int variant, int* out) {
  const KernelFn kernel = kernel_of(variant);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bgf::report_occupancy(kernel, kBlock, forces_variant_smem(cap), out);
}
