"""2D-normalized SPH smoothing kernels (port of
``bevy_gpu_fluid_tpu/ops/kernels.py``), as branch-free masked tensor
expressions.

- Poly6 (density):      W(r^2)   = 4/(pi h^8) (h^2 - r^2)^3        for r <= h
- Spiky gradient:       gradW(r) = -10/(pi h^5) (h - |r|)^2 r_hat  for 0 < |r| < h
- Viscosity Laplacian:  lapW(r)  = 40/(pi h^5) (h - |r|)           for 0 < |r| < h

``h`` and the params are float32 host scalars; the normalisations are
computed in float32 in the reference's operation order.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6
PI = np.float32(np.pi)


def w_poly6(r2: torch.Tensor, h: np.float32) -> torch.Tensor:
    """Poly6 density kernel of squared distance. Nonzero iff 0 <= r2 <= h^2."""
    h2 = h * h
    coeff = np.float32(4.0) / (PI * (h2 * h2) * (h2 * h2))
    d = float(h2) - r2
    return torch.where((r2 >= 0.0) & (r2 <= float(h2)),
                       float(coeff) * d * d * d, 0.0)


def grad_spiky(rx: torch.Tensor, ry: torch.Tensor, h: np.float32):
    """Spiky kernel gradient of the separation r_i - r_j; zero for
    |r| < EPS or |r| >= h.  Returns (gx, gy)."""
    r = torch.sqrt(rx * rx + ry * ry)
    h5 = (h * h) * (h * h) * h
    coeff = np.float32(-10.0) / (PI * h5)
    valid = (r >= EPS) & (r < float(h))
    safe_r = torch.where(valid, r, 1.0)
    d = float(h) - r
    f = torch.where(valid, float(coeff) * d * d / safe_r, 0.0)
    return f * rx, f * ry


def laplacian_visc(r: torch.Tensor, h: np.float32) -> torch.Tensor:
    """Viscosity kernel Laplacian of distance; zero for r < EPS or r >= h."""
    h5 = (h * h) * (h * h) * h
    coeff = np.float32(40.0) / (PI * h5)
    return torch.where((r >= EPS) & (r < float(h)),
                       float(coeff) * (float(h) - r), 0.0)


def eos_pressure(rho: torch.Tensor, params) -> torch.Tensor:
    """Clamped linear EOS: p = k * max(rho - rho_0, 0)."""
    return float(params.k) * torch.clamp_min(rho - float(params.rho_0), 0.0)


def self_density(params) -> np.float32:
    """m * W_poly6(0): the density an isolated particle measures."""
    h2 = params.h * params.h
    return params.m * (np.float32(4.0) / (PI * ((h2 * h2) * (h2 * h2)))) \
        * (h2 * (h2 * h2))
