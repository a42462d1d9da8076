"""Simulation parameters (port of ``bevy_gpu_fluid_tpu/core/params.py``).

``FluidParams`` and ``IntegrateConfig`` hold float32 HOST scalars
(``numpy.float32``), not tensors: the CUDA kernels take them by value, and
every constant derived from them (h^2, the Poly6/Spiky/viscosity
normalisations, the skin) is computed in float32 exactly as the JAX kernels
derive theirs (pallas_solver.py:260-293, 505-518).  Python doubles would
move the derived constants by an ulp and break element-wise parity with the
reference package.

``GridSpec2D`` keeps the reference geometry field for field: real cell
columns at lanes 1..nx of a 128-multiple ``nx_pad``, one ghost row block on
each side of ``n_row_blocks`` interior blocks, real row 0 at
``row0 = row_block + 1``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class FluidParams:
    """SPH fluid constants (float32 host scalars).

    h:     smoothing length
    rho_0: rest density
    k:     pressure stiffness (EOS p = k * max(rho - rho_0, 0))
    mu:    dynamic viscosity
    m:     particle mass
    """

    h: np.float32
    rho_0: np.float32
    k: np.float32
    mu: np.float32
    m: np.float32

    @staticmethod
    def create(h: float, rho_0: float, k: float, mu: float,
               m: float) -> "FluidParams":
        return FluidParams(h=_f32(h), rho_0=_f32(rho_0), k=_f32(k),
                           mu=_f32(mu), m=_f32(m))

    @staticmethod
    def demo() -> "FluidParams":
        """The reference demo constants (h=0.045, rho_0=1000, k=3, mu=0.2,
        m=1.6)."""
        return FluidParams.create(h=0.045, rho_0=1000.0, k=3.0, mu=0.2, m=1.6)


GRAVITY_Y = -9.81


@dataclasses.dataclass(frozen=True)
class IntegrateConfig:
    """Integration + boundary-box config (float32 host scalars).  The floor
    is a plane at ``floor_y``; there is no ceiling."""

    dt: np.float32
    x_min: np.float32
    x_max: np.float32
    bounce: np.float32
    floor_y: np.float32

    @staticmethod
    def create(dt: float = 0.0005, x_min: float = -5.0, x_max: float = 3.0,
               bounce: float = -3.0, floor_y: float = 0.0) -> "IntegrateConfig":
        return IntegrateConfig(dt=_f32(dt), x_min=_f32(x_min),
                               x_max=_f32(x_max), bounce=_f32(bounce),
                               floor_y=_f32(floor_y))


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static spatial-hash grid over the simulation domain, with the
    reference package's dense layout ``[ny_pad, cap, nx_pad]``."""

    origin_x: float
    origin_y: float
    cell_size: float
    nx: int
    ny: int
    cap: int
    row_block: int = 8

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    @property
    def nx_pad(self) -> int:
        """Columns: ghost col 0, real cols 1..nx, right padding, rounded up
        to a multiple of 128."""
        return ((self.nx + 2) + 127) // 128 * 128

    @property
    def n_row_blocks(self) -> int:
        """Interior row blocks covering ny real rows plus the two single
        ghost rows of the 3x3 stencil."""
        return -(-(self.ny + 2) // self.row_block)

    @property
    def row0(self) -> int:
        """Row index of real cell-row 0 (one ghost block + one ghost row)."""
        return self.row_block + 1

    @property
    def ny_pad(self) -> int:
        """Total rows: ghost block + interior blocks + ghost block."""
        return (self.n_row_blocks + 2) * self.row_block

    @property
    def plane_shape(self) -> tuple[int, int, int]:
        return (self.ny_pad, self.cap, self.nx_pad)

    @staticmethod
    def from_bounds(h: float, x_min: float, x_max: float,
                    y_min: float, y_max: float, cap: int = 8,
                    pad_cells: int = 2) -> "GridSpec2D":
        """Build a static grid covering the boundary box plus padding."""
        nx = int(math.ceil((x_max - x_min) / h)) + 2 * pad_cells
        ny = int(math.ceil((y_max - y_min) / h)) + 2 * pad_cells
        return GridSpec2D(origin_x=x_min - pad_cells * h,
                          origin_y=y_min - pad_cells * h,
                          cell_size=h, nx=nx, ny=ny, cap=cap)
