"""Semi-implicit Euler integration and boundary handling (port of
``bevy_gpu_fluid_tpu/ops/integrator.py``)."""

from __future__ import annotations

import torch

from ..core.params import IntegrateConfig


def euler(x, y, vx, vy, ax, ay, dt):
    """v += a*dt; x += v*dt."""
    dt = float(dt)
    vx = vx + ax * dt
    vy = vy + ay * dt
    return x + vx * dt, y + vy * dt, vx, vy


def boundaries(x, y, vx, vy, cfg: IntegrateConfig):
    """Floor + two walls: clamp the position and scale the normal velocity
    by ``bounce``.  No ceiling."""
    floor_y, x_min, x_max = float(cfg.floor_y), float(cfg.x_min), \
        float(cfg.x_max)
    bounce = float(cfg.bounce)
    below = y < floor_y
    y = torch.where(below, floor_y, y)
    vy = torch.where(below, vy * bounce, vy)

    right = x > x_max
    x = torch.where(right, x_max, x)
    vx = torch.where(right, vx * bounce, vx)

    left = x < x_min
    x = torch.where(left, x_min, x)
    vx = torch.where(left, vx * bounce, vx)
    return x, y, vx, vy
