"""Golden-model SPH solver: exact all-pairs neighbour sums in plain torch
(port of ``bevy_gpu_fluid_tpu/models/reference.py``), the port's own parity
oracle.

Step semantics (the reference's ``SPHState::step``):
  1. density (self-contribution included) + clamped EOS pressure
  2. accelerations from the NEW rho/p but pre-step pos/vel, plus gravity
  3. semi-implicit Euler:  v += a*dt;  x += v*dt
  4. boundary clamp + bounce on the floor and both walls
"""

from __future__ import annotations

import torch

from ..core.params import FluidParams, GRAVITY_Y, IntegrateConfig
from ..core.state import FluidState
from ..ops import integrator
from ..ops.kernels import eos_pressure, grad_spiky, laplacian_visc, w_poly6

_CHUNK = 1024  # rows per all-pairs block; bounds peak memory at CHUNK * N


def _row_chunks(n: int):
    for s in range(0, n, _CHUNK):
        yield s, min(s + _CHUNK, n)


def density_pressure(state: FluidState, params: FluidParams) -> FluidState:
    """rho_i = m * sum_{j: r^2 < h^2} W_poly6(r^2);  p = k*max(rho-rho_0, 0).
    The j == i self term is included."""
    x, y = state.x, state.y
    h2 = float(params.h * params.h)
    parts = []
    for s, e in _row_chunks(state.n):
        dx = x[s:e, None] - x[None, :]
        dy = y[s:e, None] - y[None, :]
        r2 = dx * dx + dy * dy
        w = torch.where(r2 < h2, w_poly6(r2, params.h), 0.0)
        parts.append(float(params.m) * w.sum(dim=1))
    rho = torch.cat(parts)
    return state.replace(rho=rho, p=eos_pressure(rho, params))


def accel_field(state: FluidState, params: FluidParams) -> FluidState:
    """Pressure + viscosity + gravity accelerations:
      a_p = -m (p_i + p_j) / (2 rho_j) * gradW_spiky(r_i - r_j)
      a_v = mu m (v_j - v_i) / rho_j * lapW_visc(|r|)"""
    x, y, vx, vy = state.x, state.y, state.vx, state.vy
    rho, p = state.rho, state.p
    h, m, mu = params.h, float(params.m), float(params.mu)
    inv_rho = torch.where(rho > 0.0, 1.0 / rho, 0.0)
    col = torch.arange(state.n, device=x.device)
    ax_parts, ay_parts = [], []
    for s, e in _row_chunks(state.n):
        dx = x[s:e, None] - x[None, :]
        dy = y[s:e, None] - y[None, :]
        r = torch.sqrt(dx * dx + dy * dy)
        not_self = (col[s:e, None] != col[None, :]).to(torch.float32)
        gx, gy = grad_spiky(dx, dy, h)
        fac_p = -m * (p[s:e, None] + p[None, :]) * (0.5 * inv_rho[None, :])
        fac_v = mu * m * laplacian_visc(r, h) * inv_rho[None, :]
        axc = not_self * (fac_p * gx + fac_v * (vx[None, :] - vx[s:e, None]))
        ayc = not_self * (fac_p * gy + fac_v * (vy[None, :] - vy[s:e, None]))
        ax_parts.append(axc.sum(dim=1))
        ay_parts.append(ayc.sum(dim=1))
    return state.replace(ax=torch.cat(ax_parts),
                         ay=torch.cat(ay_parts) + GRAVITY_Y)


def integrate(state: FluidState, cfg: IntegrateConfig) -> FluidState:
    """Semi-implicit Euler with the stored accelerations."""
    x, y, vx, vy = integrator.euler(state.x, state.y, state.vx, state.vy,
                                    state.ax, state.ay, cfg.dt)
    return state.replace(x=x, y=y, vx=vx, vy=vy)


def apply_boundaries(state: FluidState, cfg: IntegrateConfig) -> FluidState:
    """Clamp + bounce on the floor and both walls; no ceiling (``bounce``
    is negative in the demos)."""
    x, y, vx, vy = integrator.boundaries(state.x, state.y, state.vx,
                                         state.vy, cfg)
    return state.replace(x=x, y=y, vx=vx, vy=vy)


def step(state: FluidState, params: FluidParams,
         cfg: IntegrateConfig) -> FluidState:
    """One full golden-model step."""
    state = accel_field(density_pressure(state, params), params)
    state = apply_boundaries(integrate(state, cfg), cfg)
    return state.replace(step=state.step + 1)


def multi_step(state: FluidState, params: FluidParams, cfg: IntegrateConfig,
               n_steps: int) -> FluidState:
    for _ in range(n_steps):
        state = step(state, params, cfg)
    return state
