"""Hand-written CUDA stencil kernels for the SPH density and the fused
forces + integrate step, with their plain PyTorch twins.

Port of ``bevy_gpu_fluid_tpu/models/pallas_solver.py`` (the TPU Pallas
kernels), for the Verlet flagship's step:

* K1 ``density_cuda`` (``csrc/density.cu``) replaces ``_density_kernel`` /
  ``density_pallas`` (pallas_solver.py:224, :854);
* K2 ``forces_integrate_cuda`` (``csrc/forces_integrate.cu``) replaces
  ``_forces_integrate_kernel`` / ``forces_integrate_pallas``
  (pallas_solver.py:400, :961), ref-based trigger.

The dense plane is float32 ``[ny_pad, cap, nx_pad]`` (ops/binning.py).
Both kernels loop over the 3x3 neighbour cells x ``kmax`` slots in
(kj, dx, dy) order, with ``kmax`` the per-row-block bound ``occ``
(ops/reslot.block_kmax3); slots past a cell's occupancy hold FAR and add
exactly 0.  Neighbour columns wrap modulo ``nx_pad`` like the TPU lane
roll.  Each wrapper owns the ghost-block fills of its outputs (rho 0,
positions FAR, velocities 0): a garbage or NaN ghost row would poison the
neighbouring real rows through p_j.

On a CPU tensor a wrapper computes with its twin; on a CUDA tensor it
launches its kernel (and counts the launch) or raises.  The twins are
written in the kernels' own form — the softened force gate and
1/max(rho, 1e-12), the (kj, dx, dy) sum order, the same per-row slot
bound — so kernel and twin differ only by FMA contraction on the card.
The physics constants are float32 and derived in float32 in the Pallas
kernels' operation order (``_density_consts``, ``_forces_consts``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import FluidParams, GRAVITY_Y, GridSpec2D, IntegrateConfig
from ..kernels import _build
from ..ops.binning import FAR
from ..ops.kernels import PI
from ..ops.reslot import taps

_f32 = np.float32
EPS2 = _f32(1e-6 * 1e-6)   # softening of the force gate, EPS^2


def _density_consts(params: FluidParams):
    """(h^2, m * 4 / (pi h^8)) in float32, as pallas_solver.py:262, 293."""
    h2 = params.h * params.h
    return h2, (params.m * _f32(4.0)) / (PI * (h2 * h2) * (h2 * h2))


def _forces_consts(params: FluidParams) -> dict:
    """Pair-loop constants in float32, as pallas_solver.py:515-518, 572-574:
    ``m_half = -m * 0.5``, ``spiky_c = -10 / (pi h^5)`` and
    ``visc_mc = mu * m * 40 / (pi h^5)``."""
    h = params.h
    h5 = (h * h) * (h * h) * h
    visc_c = _f32(40.0) / (PI * h5)
    return dict(h=h, m_half=-params.m * _f32(0.5),
                spiky_c=_f32(-10.0) / (PI * h5),
                visc_mc=params.mu * params.m * visc_c)


def _row_kmax(occ: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """Slot-loop bound per row, [ny_pad, 1, 1]: the row block's max over
    the three row shifts, 0 on the ghost blocks (which the kernels never
    compute)."""
    tb = grid.row_block
    km = torch.zeros(grid.ny_pad, dtype=torch.int64, device=occ.device)
    km[tb:tb + grid.n_row_blocks * tb] = \
        occ.amax(dim=0).to(torch.int64).repeat_interleave(tb)
    return km[:, None, None]


# ---------------------------------------------------------------------------
# K1: density
# ---------------------------------------------------------------------------

def density_torch(xd, yd, params: FluidParams, grid: GridSpec2D,
                  occ) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1: rho = coeff * sum max(h^2 - r^2,
    0)^3 in (kj, dx, dy) order; ghost blocks 0."""
    h2, coeff = _density_consts(params)
    kmax = _row_kmax(occ, grid)
    rho = torch.zeros_like(xd)
    for kj in range(int(kmax.max())):
        on = kj < kmax
        for rx, ry in taps((xd, yd), kj):
            ddx = xd - rx
            ddy = yd - ry
            d = torch.clamp_min(float(h2) - (ddx * ddx + ddy * ddy), 0.0)
            rho = torch.where(on, rho + d * d * d, rho)
    return rho * float(coeff)


def density_cuda(xd, yd, params: FluidParams, grid: GridSpec2D,
                 occ) -> torch.Tensor:
    """Density stencil over the dense grid (kernel K1).  ``occ`` is the
    sim's cached ``block_kmax3``.  Returns rho_d with ghost blocks 0."""
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd)
    if dev.type == "cpu":
        return density_torch(xd, yd, params, grid, occ)
    h2, coeff = _density_consts(params)
    rho = torch.empty_like(xd)
    _build.launch("bgf_density", dev, xd.data_ptr(), yd.data_ptr(),
                  occ.data_ptr(), rho.data_ptr(), grid.ny_pad, grid.cap,
                  grid.nx_pad, grid.row_block, grid.n_row_blocks, float(h2),
                  float(coeff))
    density_cuda.launches += 1
    return rho


density_cuda.launches = 0


# ---------------------------------------------------------------------------
# K2: forces + integrate + bounce + skin displacement
# ---------------------------------------------------------------------------

def forces_integrate_torch(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                           params: FluidParams, cfg: IntegrateConfig,
                           grid: GridSpec2D, occ):
    """Plain PyTorch twin of kernel K2.  Returns (xd', yd', vxd', vyd',
    disp2) with disp2 a float32 0-dim tensor."""
    c = _forces_consts(params)
    h, m_half, spiky_c, visc_mc = (float(c[k]) for k in
                                   ("h", "m_half", "spiky_c", "visc_mc"))
    k, rho0 = float(params.k), float(params.rho_0)
    p = k * torch.clamp_min(rho_d - rho0, 0.0)
    ir = 1.0 / torch.clamp_min(rho_d, 1e-12)
    kmax = _row_kmax(occ, grid)
    ax = torch.zeros_like(xd)
    ay = torch.zeros_like(xd)
    for kj in range(int(kmax.max())):
        on = kj < kmax
        for rx, ry, rvx, rvy, rp, ri in taps((xd, yd, vxd, vyd, p, ir),
                                             kj):
            ddx = xd - rx
            ddy = yd - ry
            r2 = ddx * ddx + ddy * ddy
            inv_r = torch.rsqrt(r2 + float(EPS2))
            hr = torch.clamp_min(h - r2 * inv_r, 0.0)
            fac_p = m_half * (p + rp) * ri * (spiky_c * hr * hr * inv_r)
            fac_v = visc_mc * ri * hr
            ax = torch.where(on, ax + (fac_p * ddx + fac_v * (rvx - vxd)), ax)
            ay = torch.where(on, ay + (fac_p * ddy + fac_v * (rvy - vyd)), ay)

    dt = float(cfg.dt)
    bounce = float(cfg.bounce)
    live = xd < 1e8
    vx = vxd + ax * dt
    vy = vyd + (ay + GRAVITY_Y) * dt
    x = xd + vx * dt
    y = yd + vy * dt
    below = y < float(cfg.floor_y)
    y = torch.where(below, float(cfg.floor_y), y)
    vy = torch.where(below, vy * bounce, vy)
    right = x > float(cfg.x_max)
    x = torch.where(right, float(cfg.x_max), x)
    vx = torch.where(right, vx * bounce, vx)
    left = x < float(cfg.x_min)
    x = torch.where(left, float(cfg.x_min), x)
    vx = torch.where(left, vx * bounce, vx)
    x = torch.where(live, x, xd)
    y = torch.where(live, y, yd)
    vx = torch.where(live, vx, 0.0)
    vy = torch.where(live, vy, 0.0)
    drx = x - ref_xd
    dry = y - ref_yd
    disp2 = torch.where(live, drx * drx + dry * dry, 0.0).amax()

    tb = grid.row_block
    for plane, fill in ((x, FAR), (y, FAR), (vx, 0.0), (vy, 0.0)):
        plane[:tb] = fill
        plane[-tb:] = fill
    return x, y, vx, vy, disp2


def forces_integrate_cuda(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                          params: FluidParams, cfg: IntegrateConfig,
                          grid: GridSpec2D, occ):
    """Fused forces + integrate + bounce + skin-displacement pass (kernel
    K2).  Returns (xd', yd', vxd', vyd', disp2): new planes with FAR/0
    ghost blocks, and the max squared displacement of the new live
    positions from the rebin reference as a float32 0-dim tensor (the next
    step's rebin trigger)."""
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              rho_d=rho_d, ref_xd=ref_xd, ref_yd=ref_yd)
    if dev.type == "cpu":
        return forces_integrate_torch(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                                      params, cfg, grid, occ)
    c = _forces_consts(params)
    outs = [torch.empty_like(xd) for _ in range(4)]
    disp = torch.empty(1, dtype=torch.float32, device=dev)
    _build.launch(
        "bgf_forces_integrate", dev, xd.data_ptr(), yd.data_ptr(),
        vxd.data_ptr(), vyd.data_ptr(), rho_d.data_ptr(), ref_xd.data_ptr(),
        ref_yd.data_ptr(), occ.data_ptr(), *(o.data_ptr() for o in outs),
        disp.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks,
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k), float(cfg.dt),
        float(cfg.x_min), float(cfg.x_max), float(cfg.bounce),
        float(cfg.floor_y))
    forces_integrate_cuda.launches += 1
    return (*outs, disp[0])


forces_integrate_cuda.launches = 0
