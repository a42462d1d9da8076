"""Particle state as a structure of arrays (port of
``bevy_gpu_fluid_tpu/core/state.py``): one float32 ``[N]`` tensor per scalar
component."""

from __future__ import annotations

import dataclasses
import math

import torch

from .params import FluidParams


@dataclasses.dataclass
class FluidState:
    """SoA particle state; every field float32[N] on one device.  ``step``
    is a host int."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    rho: torch.Tensor
    p: torch.Tensor
    step: int = 0

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "FluidState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "FluidState":
        return FluidState(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)
                            if f.name != "step"), step=self.step)


def from_positions(pos, device) -> FluidState:
    """Zero-velocity state from [N, 2] positions."""
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    z = torch.zeros(pos.shape[0], dtype=torch.float32, device=device)
    return FluidState(x=pos[:, 0].contiguous(), y=pos[:, 1].contiguous(),
                      vx=z, vy=z.clone(), ax=z.clone(), ay=z.clone(),
                      rho=z.clone(), p=z.clone())


def init_grid(n_x: int, n_y: int, spacing: float, device) -> FluidState:
    """Lattice of n_x * n_y particles at the given spacing, x-fastest
    order.  Coordinates are ``index * float32(spacing)`` in float32, as the
    JAX package computes them."""
    sp = torch.tensor(spacing, dtype=torch.float32)
    ix = torch.arange(n_x, dtype=torch.float32) * sp
    iy = torch.arange(n_y, dtype=torch.float32) * sp
    yy, xx = torch.meshgrid(iy, ix, indexing="ij")
    n = n_x * n_y
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return FluidState(x=xx.reshape(-1).to(device), y=yy.reshape(-1).to(device),
                      vx=z, vy=z.clone(), ax=z.clone(), ay=z.clone(),
                      rho=z.clone(), p=z.clone())


def lattice_gen(n_x: int, spacing: float, device):
    """Chunk generator of the ``init_grid(n_x, n_y, spacing)`` lattice that
    never materializes it: maps an int tensor of GLOBAL particle indices
    (on any device) to that chunk's (x, y, vx, vy) float32 tensors on
    ``device``, at rest, x-fastest order, with ``init_grid``'s float32
    arithmetic (index * float32(spacing)).  For
    ``verlet_solver.init_dense_gen`` / ``Session.from_generator``: at very
    large N the four [N] planes of a FluidState are a real share of the
    card's memory."""
    sp = torch.tensor(spacing, dtype=torch.float32)

    def gen(gi: torch.Tensor):
        gi = gi.to(device)
        x = (gi % n_x).to(torch.float32) * sp.to(device)
        y = torch.div(gi, n_x, rounding_mode="floor").to(torch.float32) \
            * sp.to(device)
        z = torch.zeros_like(x)
        return x, y, z, z.clone()
    return gen


def demo_block_5k(device) -> tuple[FluidState, FluidParams]:
    """The 71x71 = 5,041 particle dam-break block."""
    return init_grid(71, 71, 0.04, device), FluidParams.demo()


def make_state(count: int, device) -> tuple[FluidState, FluidParams]:
    """sqrt(count)-square lattice, the FPS-bench scene builder."""
    n = int(math.isqrt(count))
    return init_grid(n, n, 0.04, device), FluidParams.demo()
