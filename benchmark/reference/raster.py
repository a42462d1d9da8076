"""The density-field frame in plain PyTorch: the yardstick for the port's
field raster.  It imports nothing of the program.

The frame samples the SPH density ``m * 4 / (pi h^8) * sum (h^2 -
r^2)^3`` of the active particles at the centres of a P x P lattice of
pixels in every cell of the configuration's grid (cells of ``skin * h``
over ``[x_min, x_max] x [0, y_max]`` padded by two cells a side), so
pixel column X, row Y (from the bottom) is centred on ``(ox + (X + 0.5) *
cell / P, oy + (Y + 0.5) * cell / P)``.  Wet pixels (density above 5% of
``rho_0``) take the blue -> cyan -> yellow -> red ramp of ``(rho - lo) /
(hi - lo)``, ``lo`` the least wet density and ``hi`` the largest; dry
pixels are black.  Each channel is quantised as ``floor(v * 255 + 0.5)``
and the rows are flipped, so row 0 is the top.
"""

from __future__ import annotations

import math

import torch

from .neighbours import CellList, blocks


def grid_geometry(sc: dict) -> dict:
    """Origin, cell side and cell counts of the configuration's grid."""
    cell = float(sc["h"]) * float(sc["skin"])
    pad = 2
    nx = math.ceil((float(sc["x_max"]) - float(sc["x_min"])) / cell) + 2 * pad
    ny = math.ceil(float(sc["y_max"]) / cell) + 2 * pad
    return dict(ox=float(sc["x_min"]) - pad * cell, oy=-pad * cell,
                cell=cell, nx=nx, ny=ny)


def field(x, y, sc: dict, P: int, dtype=torch.float64,
          pair_dtype=None) -> torch.Tensor:
    """Density at every pixel centre, [ny * P, nx * P], row 0 the bottom,
    in ``dtype`` (the pair sums in ``pair_dtype`` where given)."""
    pair_dtype = dtype if pair_dtype is None else pair_dtype
    g = grid_geometry(sc)
    h = float(sc["h"])
    h2 = h * h
    rho_c = float(sc["m"]) * 4.0 / (math.pi * h ** 8)
    H, W = g["ny"] * P, g["nx"] * P
    step = g["cell"] / P
    col = torch.arange(W, dtype=torch.float64, device=x.device)
    row = torch.arange(H, dtype=torch.float64, device=x.device)
    px = (g["ox"] + (col + 0.5) * step).repeat(H)
    py = (g["oy"] + (row + 0.5) * step).repeat_interleave(W)
    cl = CellList(x, y, h)
    xs, ys = x.to(dtype), y.to(dtype)
    qx, qy = px.to(dtype), py.to(dtype)
    out = torch.empty(H * W, dtype=dtype, device=x.device)
    for lo, hi in blocks(H * W):
        acc = torch.zeros(hi - lo, dtype=pair_dtype, device=x.device)
        for j, ok in cl.candidates(qx, qy, lo, hi):
            dx = (qx[lo:hi] - xs[j]).to(pair_dtype)
            dy = (qy[lo:hi] - ys[j]).to(pair_dtype)
            d = torch.clamp_min(h2 - (dx * dx + dy * dy), 0.0)
            acc = acc + torch.where(ok, d * d * d, 0.0)
        out[lo:hi] = (acc * rho_c).to(dtype)
    return out.reshape(H, W)


def colour(rho: torch.Tensor, rho_0: float) -> torch.Tensor:
    """uint8 [H, W, 3] frame of a density field (row 0 = bottom in,
    row 0 = top out), in the field's precision."""
    wet = rho > 0.05 * rho_0
    lo = torch.where(wet, rho, torch.inf).min()
    hi = rho.max()
    t = torch.where(hi > lo, (rho - lo) / (hi - lo), 0.0).clamp(0.0, 1.0)
    u1, u2, u3 = t * 2.0, (t - 0.5) / 0.25, (t - 0.75) / 0.25
    low, mid = t < 0.5, t < 0.75
    r = torch.where(low, 0.0, torch.where(mid, u2, 1.0))
    g = torch.where(low, u1, torch.where(mid, 1.0, 1.0 - u3))
    b = torch.where(low, 1.0, torch.where(mid, 1.0 - u2, 0.0))
    planes = [torch.where(wet, c, 0.0) for c in (r, g, b)]
    q = [torch.floor(torch.clamp(c * 255.0 + 0.5, 0.0, 255.0))
         .to(torch.uint8).flip(0) for c in planes]
    return torch.stack(q, dim=-1)


def frame(x, y, sc: dict, P: int, dtype=torch.float64,
          pair_dtype=None) -> torch.Tensor:
    """The finished uint8 frame of the active particles (x, y), computed in
    ``dtype`` (the pair sums in ``pair_dtype`` where given)."""
    return colour(field(x, y, sc, P, dtype, pair_dtype), float(sc["rho_0"]))
