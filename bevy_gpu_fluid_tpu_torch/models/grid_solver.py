"""Eager grid solver: sort-based binning every step + the dense 3x3 cell
stencil (port of ``bevy_gpu_fluid_tpu/models/grid_solver.py``).

Each step bins the particles into the dense slot grid ``[ny_pad, cap,
nx_pad]`` (ops/binning.py), runs a density and a forces stencil over it,
reads rho and the accelerations back per particle and integrates.  The
stencils are a pluggable pair ``(density_fn, forces_fn)``:

* ``XLA_STENCILS`` (``density_xla``, ``forces_xla``): the reference's
  ``"xla"`` solver, plain torch ops here.  They keep the golden model's
  HARD ``r >= EPS`` gate and exclude the centre slot's self pair by slot
  identity, as the reference's XLA stencils do;
* ``cuda_solver.make_stencils(grid)``: kernels K1 and K8, the reference's
  ``"pallas"`` solver (softened force gate, see models/cuda_solver.py).

Overflowed particles (cell occupancy > cap) get no slot: they fall back to
the self-density and gravity-only acceleration, and the step reports the
count in ``StepDiag.overflow`` (a host int; reading it syncs).
``multi_step`` is a Python loop where the reference runs ``lax.scan``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams, GRAVITY_Y, GridSpec2D, IntegrateConfig
from ..core.state import FluidState
from ..ops import integrator
from ..ops.binning import FAR, bin_particles, from_dense_multi, to_dense
from ..ops.kernels import (eos_pressure, grad_spiky, laplacian_visc,
                           self_density, w_poly6)
from ..utils.profiling import span

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@dataclasses.dataclass
class StepDiag:
    """Per-step diagnostics: ``overflow``, the particles the binning left
    without a slot (a host int)."""

    overflow: int


def _nbr(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """View with nbr[y, k, x] = a[y+dy, k, x+dx] (wrapping; the ghost
    border keeps wrapped values out of real outputs)."""
    if dy == 0 and dx == 0:
        return a
    return torch.roll(a, (-dy, -dx), (0, 2))


def density_xla(xd, yd, params: FluidParams, occ=None) -> torch.Tensor:
    """rho over dense slots: m * sum over the 3x3-cell neighbour slots of
    W_poly6(r^2) gated by r^2 < h^2, self term included.  ``occ`` is
    accepted for the stencil interface and ignored (all cap slots)."""
    h = params.h
    h2 = float(h * h)
    rho = torch.zeros_like(xd)
    for dy, dx in OFFSETS:
        nxs = _nbr(xd, dy, dx)
        nys = _nbr(yd, dy, dx)
        for kj in range(xd.shape[1]):
            ddx = xd - nxs[:, kj:kj + 1, :]
            ddy = yd - nys[:, kj:kj + 1, :]
            r2 = ddx * ddx + ddy * ddy
            rho = rho + torch.where(r2 < h2, w_poly6(r2, h), 0.0)
    return float(params.m) * rho


def forces_xla(xd, yd, vxd, vyd, rho_d, params: FluidParams,
               occ=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pressure + viscosity accelerations over dense slots:
       a_p = -m (p_i + p_j) / (2 rho_j) gradW_spiky(r)
       a_v = mu m (v_j - v_i) / rho_j lapW_visc(|r|)
    with the golden model's hard r >= EPS gate; the j == i pair is excluded
    by slot identity at the centre offset.  No gravity."""
    h = params.h
    h2 = float(h * h)
    cap = xd.shape[1]
    m_half = float(-params.m * np.float32(0.5))
    mu_m = float(params.mu * params.m)
    p_d = eos_pressure(rho_d, params)
    inv_rho_d = torch.where(rho_d > 0.0, 1.0 / rho_d, 0.0)
    ax = torch.zeros_like(xd)
    ay = torch.zeros_like(xd)
    ki = torch.arange(cap, device=xd.device)[None, :, None]
    for dy, dx in OFFSETS:
        nxs, nys = _nbr(xd, dy, dx), _nbr(yd, dy, dx)
        nvx, nvy = _nbr(vxd, dy, dx), _nbr(vyd, dy, dx)
        nir, npp = _nbr(inv_rho_d, dy, dx), _nbr(p_d, dy, dx)
        center = dy == 0 and dx == 0
        for kj in range(cap):
            ddx = xd - nxs[:, kj:kj + 1, :]
            ddy = yd - nys[:, kj:kj + 1, :]
            r2 = ddx * ddx + ddy * ddy
            ok = r2 < h2
            if center:
                ok = ok & (ki != kj)
            gx, gy = grad_spiky(ddx, ddy, h)
            ir = nir[:, kj:kj + 1, :]
            fac_p = m_half * (p_d + npp[:, kj:kj + 1, :]) * ir
            fac_v = mu_m * laplacian_visc(torch.sqrt(r2), h) * ir
            ax = ax + torch.where(
                ok, fac_p * gx + fac_v * (nvx[:, kj:kj + 1, :] - vxd), 0.0)
            ay = ay + torch.where(
                ok, fac_p * gy + fac_v * (nvy[:, kj:kj + 1, :] - vyd), 0.0)
    return ax, ay


XLA_STENCILS = (density_xla, forces_xla)


def compute_rho_p_acc(state: FluidState, params: FluidParams,
                      grid: GridSpec2D,
                      stencils=XLA_STENCILS) -> tuple[FluidState, StepDiag]:
    """Density, EOS pressure and accelerations (gravity included) at the
    state's positions, through the given stencils; no integration."""
    density_fn, forces_fn = stencils
    # all four scatters ahead of the stencils: one span holds the binning
    with span("bgf.binning"):
        binned = bin_particles(state.x, state.y, grid)
        xd = to_dense(binned, state.x, FAR)
        yd = to_dense(binned, state.y, FAR)
        vxd = to_dense(binned, state.vx, 0.0)
        vyd = to_dense(binned, state.vy, 0.0)
    rho_d = density_fn(xd, yd, params)
    ax_d, ay_d = forces_fn(xd, yd, vxd, vyd, rho_d, params)
    rho, ax, ay = from_dense_multi(binned, [rho_d, ax_d, ay_d],
                                   [float(self_density(params)), 0.0, 0.0])
    out = state.replace(ax=ax, ay=ay + GRAVITY_Y, rho=rho,
                        p=eos_pressure(rho, params))
    return out, StepDiag(overflow=binned.overflow)


def step_with_diag(state: FluidState, params: FluidParams,
                   cfg: IntegrateConfig, grid: GridSpec2D,
                   stencils=XLA_STENCILS) -> tuple[FluidState, StepDiag]:
    """One full step (bin, density, pressure, forces, integrate, bounce)
    and its diagnostics."""
    with span("bgf.step"):
        state, diag = compute_rho_p_acc(state, params, grid, stencils)
        x, y, vx, vy = integrator.euler(state.x, state.y, state.vx,
                                        state.vy, state.ax, state.ay, cfg.dt)
        x, y, vx, vy = integrator.boundaries(x, y, vx, vy, cfg)
        return (state.replace(x=x, y=y, vx=vx, vy=vy, step=state.step + 1),
                diag)


def step(state: FluidState, params: FluidParams, cfg: IntegrateConfig,
         grid: GridSpec2D, stencils=XLA_STENCILS) -> FluidState:
    return step_with_diag(state, params, cfg, grid, stencils)[0]


def multi_step(state: FluidState, params: FluidParams, cfg: IntegrateConfig,
               grid: GridSpec2D, n_steps: int,
               stencils=XLA_STENCILS) -> tuple[FluidState, StepDiag]:
    """n_steps steps; the StepDiag holds the largest per-step overflow."""
    worst = 0
    for _ in range(n_steps):
        state, diag = step_with_diag(state, params, cfg, grid, stencils)
        worst = max(worst, diag.overflow)
    return state, StepDiag(overflow=worst)


def default_grid(params_h: float, cfg_x_min: float, cfg_x_max: float,
                 y_max: float, cap: int = 8) -> GridSpec2D:
    """Grid of cell h over the boundary box with headroom above (there is
    no ceiling, so y_max is splash margin)."""
    return GridSpec2D.from_bounds(h=params_h, x_min=cfg_x_min,
                                  x_max=cfg_x_max, y_min=0.0, y_max=y_max,
                                  cap=cap)
