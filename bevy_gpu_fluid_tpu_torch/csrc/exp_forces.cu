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
//   v3    v2 with the slot loop unrolled by two.  An odd bound rounds up;
//         the extra slot is FAR (staged as FAR past kmax, never read from
//         the plane), so it adds exactly 0 and v3 is bitwise v2.
//
// What bounds it on the H100: K8's bytes (7 planes) at its tile; the
// variants change only the per-tap instruction count (~45 for v0, a few
// fewer for v1-v3; v0nr drops the MUFU rsqrt), which decides how far the
// taps overlap the staging.
//
// Design: K8's halo tile unchanged (bgf_common.cuh: the window staged once
// in shared memory, (x, y, vx, vy) as a float4 and (p, 1/rho) as a float2,
// the live pairs listed, a thread per live pair, dead slots +0 from the
// counts), with the tap loop a template of the variant.  The window holds
// an even number of slots per cell for v3 (ks = kmax rounded up).

#include "bgf_common.cuh"

namespace {

constexpr int kBlock = bgf::kThreads;  // 256, as K8
enum Variant : int { kV0 = 0, kV0nr = 1, kV1 = 2, kV2 = 3, kV3 = 4 };
constexpr float kEpsNr = 1.0e-6f;  // v0nr's r^2 + EPS

struct VariantConsts {
  bgf::ForceConsts fc;  // h, -m/2, spiky_c, mu m visc_c (= C2)
  float c1;             // (-m/2) spiky_c
};

// Slots per window cell staged for v3 at slot capacity cap: even.
__host__ __device__ __forceinline__ int slots_staged(int cap) {
  return cap + (cap & 1);
}

// Dynamic shared memory: K8's (the windows at an even slot count).
int forces_variant_smem(int cap) {
  return bgf::kWinRows * slots_staged(cap) * bgf::kWinCols * (16 + 8) +
         bgf::kWinRows * bgf::kWinCols * 4 + bgf::kTileCells * cap * 4 + 4;
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

// bgf::tile_accel with the variant's tap: slots kj < kb in (kj, dx, dy)
// order (v3: kb rounded up to even, two slots an iteration).
template <int V>
__device__ __forceinline__ float2 tile_accel_v(const float4* win,
                                               const float2* eos, int b0,
                                               int rs, int kb, float4 own,
                                               float p_i,
                                               const VariantConsts& c) {
  constexpr int kTap = V == kV3 ? kV2 : V;
  constexpr int kUnroll = V == kV3 ? 2 : 1;
  float ax = 0.0f;
  float ay = 0.0f;
  float sv = 0.0f;
  for (int k0 = 0; k0 < kb; k0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kj = k0 + u;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int j = b0 + dy * rs + kj * bgf::kWinCols + dx;
          const float4 w = win[j];
          const float2 e = eos[j];
          pair_term<kTap>(own.x - w.x, own.y - w.y, p_i + e.x, e.y, w.z, w.w,
                          own, c, ax, ay, sv);
        }
    }
  }
  if (kTap == kV2) {
    ax = ax - own.z * sv;
    ay = ay - own.w * sv;
  }
  return make_float2(ax, ay);
}

template <int V>
__global__ void __launch_bounds__(kBlock) forces_variant_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ rho, const int* __restrict__ occ,
    float* __restrict__ ax_out, float* __restrict__ ay_out, int cap,
    int nx_pad, int tb, int nb, VariantConsts c, float rho0, float k) {
  using namespace bgf;
  const Tile t = tile_of(nx_pad, tb);
  const long long base = static_cast<long long>(t.row0 - 1) * cap * nx_pad;
  if (t.rb == 0 || t.rb == nb + 1) {
    for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
    });
    return;
  }
  const int ks_cap = slots_staged(cap);
  extern __shared__ float4 win[];  // kWinRows x ks x kWinCols
  float2* eos = reinterpret_cast<float2*>(win + kWinRows * ks_cap * kWinCols);
  int* cnt = reinterpret_cast<int*>(eos + kWinRows * ks_cap * kWinCols);
  int* pairs = cnt + kWinRows * kWinCols;
  int* n_pairs = pairs + kTileCells * cap;

  const int kmax = block_kmax(occ, nb, t.rb - 1);
  const int ks = V == kV3 ? kmax + (kmax & 1) : kmax;
  // stage_force_window's staging with ks slots a cell: slots at or past
  // kmax (v3's odd one) are FAR without a read
  stage_window<kBlock>(t, ks, cap, nx_pad, cnt, [&](int i, int off) {
    if (off < 0 || (V == kV3 && (i / kWinCols) % ks >= kmax)) {
      win[i] = make_float4(kFar, kFar, 0.0f, 0.0f);
      eos[i] = make_float2(0.0f, 0.0f);
      return kFar;
    }
    const long long g = base + off;
    const float xg = x[g];
    const float rg = rho[g];
    win[i] = make_float4(xg, y[g], vx[g], vy[g]);
    eos[i] = make_float2(k * fmaxf(rg - rho0, 0.0f),
                         1.0f / fmaxf(rg, 1.0e-12f));
    return xg;
  });
  __syncthreads();
  if (threadIdx.x < 32) list_pairs(t, kmax, cnt, pairs, n_pairs);
  __syncthreads();

  const int np = *n_pairs;
  const int rs = ks * kWinCols;  // window row stride
  for (int p = threadIdx.x; p < np; p += kBlock) {
    const int cell = pairs[p] >> 8;
    const int s = pairs[p] & 255;
    const int tr = cell / kTileCols;
    const int tc = cell - tr * kTileCols;
    const int own_i = (tr + 1) * rs + s * kWinCols + tc + 1;
    const float2 a = tile_accel_v<V>(win, eos, tr * rs + tc, rs,
                                     neighbour_counts(cnt, tr, tc).x,
                                     win[own_i], eos[own_i].x, c);
    const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
    ax_out[g] = a.x;
    ay_out[g] = a.y;
  }
  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {
    if (s >= cnt[(tr + 1) * kWinCols + tc + 1]) {
      const long long g = base + tile_offset(t, tr, s, tc, cap, nx_pad);
      ax_out[g] = 0.0f;
      ay_out[g] = 0.0f;
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

// variant: 0 v0, 1 v0nr, 2 v1, 3 v2, 4 v3.  c1 = m_half * spiky_c.
extern "C" int bgf_forces_variant(const float* x, const float* y,
                                  const float* vx, const float* vy,
                                  const float* rho, const int* occ, float* ax,
                                  float* ay, int ny_pad, int cap, int nx_pad,
                                  int tb, int nb, int variant, float h,
                                  float m_half, float spiky_c, float visc_mc,
                                  float c1, float rho0, float k,
                                  cudaStream_t stream) {
  const KernelFn kernel = kernel_of(variant);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = forces_variant_smem(cap);
  const cudaError_t err = bgf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bgf::tiles_for(ny_pad, nx_pad, tb), kBlock, smem, stream>>>(
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
