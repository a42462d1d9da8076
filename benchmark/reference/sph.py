"""The dam-break configurations' SPH step in plain PyTorch: the yardstick
that judges what the port computes.  It imports nothing of the program.

One step of the upstream engine (bevy_gpu_fluid's ``SPHState::step``,
2D-normalised kernels):

1. density of every active particle over the active particles within
   ``h``, itself included: ``rho_i = m * 4 / (pi h^8) * sum (h^2 - r^2)^3``;
2. pressure ``p = k * max(rho - rho_0, 0)``;
3. acceleration over the others within ``h``: pressure
   ``-m (p_i + p_j) / (2 rho_j) * gradW_spiky``, with ``gradW_spiky(r) =
   -10 / (pi h^5) (h - |r|)^2 r / |r|``, plus viscosity ``mu m (v_j - v_i)
   / rho_j * 40 / (pi h^5) (h - |r|)``, plus gravity;
4. semi-implicit Euler, ``v += a dt; x += v dt``, then the floor and the
   two walls clamp the position and scale the normal velocity by
   ``bounce``.

``dtype`` is the precision of the whole step: float64 for the reference,
bfloat16 for the control (the precision below the configurations'
float32); ``pair_dtype``, where given, that of the pair sums alone (the
state in ``dtype``).  The constants are the configuration's, as Python
floats.
"""

from __future__ import annotations

import math

import torch

from .neighbours import CellList, blocks

GRAVITY = -9.81
EPS = 1e-6       # pairs closer than this exert no pressure or viscosity


def _consts(sc: dict) -> dict:
    h = float(sc["h"])
    return dict(h=h, h2=h * h, rho_c=float(sc["m"]) * 4.0 / (math.pi * h ** 8),
                spiky=-10.0 / (math.pi * h ** 5),
                visc=40.0 / (math.pi * h ** 5))


def density(x, y, sc: dict, pair_dtype=torch.float64) -> torch.Tensor:
    """rho of every point (x, y) over the same points, self included."""
    c = _consts(sc)
    cl = CellList(x, y, c["h"])
    out = torch.empty(x.shape[0], dtype=pair_dtype, device=x.device)
    for lo, hi in blocks(x.shape[0]):
        xi, yi = x[lo:hi], y[lo:hi]
        acc = torch.zeros(hi - lo, dtype=pair_dtype, device=x.device)
        for j, ok in cl.candidates(x, y, lo, hi):
            dx = (xi - x[j]).to(pair_dtype)
            dy = (yi - y[j]).to(pair_dtype)
            d = torch.clamp_min(c["h2"] - (dx * dx + dy * dy), 0.0)
            acc = acc + torch.where(ok, d * d * d, 0.0)
        out[lo:hi] = acc * c["rho_c"]
    return out


def accel(x, y, vx, vy, rho, sc: dict, pair_dtype=torch.float64):
    """Pressure + viscosity accelerations (no gravity) of every particle
    over the others within h."""
    c = _consts(sc)
    h = c["h"]
    m, mu = float(sc["m"]), float(sc["mu"])
    p = float(sc["k"]) * torch.clamp_min(rho - float(sc["rho_0"]), 0.0)
    inv_rho = 1.0 / rho
    cl = CellList(x, y, h)
    n = x.shape[0]
    ax = torch.empty(n, dtype=pair_dtype, device=x.device)
    ay = torch.empty_like(ax)
    for lo, hi in blocks(n):
        i = torch.arange(lo, hi, device=x.device)
        xi, yi, vxi, vyi, pi = x[lo:hi], y[lo:hi], vx[lo:hi], vy[lo:hi], \
            p[lo:hi]
        sx = torch.zeros(hi - lo, dtype=pair_dtype, device=x.device)
        sy = torch.zeros_like(sx)
        for j, ok in cl.candidates(x, y, lo, hi):
            dx = (xi - x[j]).to(pair_dtype)
            dy = (yi - y[j]).to(pair_dtype)
            r = torch.sqrt(dx * dx + dy * dy)
            on = ok & (j != i) & (r >= EPS) & (r < h)
            hr = torch.clamp_min(h - r, 0.0)
            safe = torch.where(on, r, 1.0)
            fp = (-m * 0.5) * (pi + p[j]) * inv_rho[j] * (
                c["spiky"] * hr * hr / safe)
            fv = mu * m * c["visc"] * hr * inv_rho[j]
            tx = fp * dx + fv * (vx[j] - vxi).to(pair_dtype)
            ty = fp * dy + fv * (vy[j] - vyi).to(pair_dtype)
            sx = sx + torch.where(on, tx, 0.0)
            sy = sy + torch.where(on, ty, 0.0)
        ax[lo:hi], ay[lo:hi] = sx, sy
    return ax, ay


def step(x, y, vx, vy, sc: dict, dtype=torch.float64,
         pair_dtype=None) -> dict:
    """One step of the active particles (x, y, vx, vy): returns their rho
    (at the old positions) and new x, y, vx, vy, in ``dtype``."""
    pair_dtype = dtype if pair_dtype is None else pair_dtype
    x, y, vx, vy = (t.to(dtype) for t in (x, y, vx, vy))
    rho = density(x, y, sc, pair_dtype)
    ax, ay = accel(x, y, vx, vy, rho, sc, pair_dtype)
    dt = float(sc["dt"])
    vx = vx + ax.to(dtype) * dt
    vy = vy + (ay.to(dtype) + GRAVITY) * dt
    x = x + vx * dt
    y = y + vy * dt
    bounce = float(sc["bounce"])
    below = y < float(sc["floor_y"])
    y = torch.where(below, float(sc["floor_y"]), y)
    vy = torch.where(below, vy * bounce, vy)
    right = x > float(sc["x_max"])
    x = torch.where(right, float(sc["x_max"]), x)
    vx = torch.where(right, vx * bounce, vx)
    left = x < float(sc["x_min"])
    x = torch.where(left, float(sc["x_min"]), x)
    vx = torch.where(left, vx * bounce, vx)
    return dict(rho=rho.to(dtype), x=x, y=y, vx=vx, vy=vy)
