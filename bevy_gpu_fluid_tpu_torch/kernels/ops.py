"""The Session path's kernels as ``torch.library`` custom operators, so that
``torch.export`` can trace a step through them (``utils/aot.py``).

Each operator's one implementation is the kernel's wrapper itself: on a
CUDA tensor it launches the hand-written kernel through the ``ctypes``
library (and counts the launch), on a CPU tensor it runs the PyTorch
twin, exactly as a direct call does; ``register_fake`` gives the output
shapes for tracing.  The physics and the grid cross the operator boundary
as float lists (``pack_params``, ``pack_cfg``, ``pack_grid``: float32
constants and grid integers are exact as doubles), so a traced graph holds
them as constants.

The functions at the bottom take the wrappers' own arguments
(``density_cuda``, ``forces_integrate_cuda``, ``mono_step_cuda``,
``reslot_cuda``), so this module can stand in for ``models.cuda_solver``
and ``ops.reslot`` where a step is built (``make_step_parts(...,
kernels=ops)``).  The Session's own path keeps calling the wrappers: the
dispatcher adds host time per call on a path that the host already bounds.

    bgf::density           K1   (csrc/density.cu)
    bgf::forces_integrate  K2   (csrc/forces_integrate.cu), both triggers,
                                the lane window
    bgf::mono_step         K5   (csrc/mono_step.cu)
    bgf::reslot            K3   (csrc/reslot.cu), the single card's clip
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..models import cuda_solver
from ..ops import reslot as reslot_ops

_PARAMS = ("h", "rho_0", "k", "mu", "m")
_CFG = ("dt", "x_min", "x_max", "bounce", "floor_y")
_GRID = ("origin_x", "origin_y", "cell_size", "nx", "ny", "cap",
         "row_block")


def pack_params(p: FluidParams) -> list:
    return [float(getattr(p, k)) for k in _PARAMS]


def pack_cfg(c: IntegrateConfig) -> list:
    return [float(getattr(c, k)) for k in _CFG]


def pack_grid(g: GridSpec2D) -> list:
    return [float(getattr(g, k)) for k in _GRID]


def params_of(v) -> FluidParams:
    return FluidParams(**{k: np.float32(x) for k, x in zip(_PARAMS, v)})


def cfg_of(v) -> IntegrateConfig:
    return IntegrateConfig(**{k: np.float32(x) for k, x in zip(_CFG, v)})


def grid_of(v) -> GridSpec2D:
    return GridSpec2D(origin_x=v[0], origin_y=v[1], cell_size=v[2],
                      nx=int(v[3]), ny=int(v[4]), cap=int(v[5]),
                      row_block=int(v[6]))


# ---- the operators -------------------------------------------------------

@torch.library.custom_op("bgf::density", mutates_args=())
def _density(xd: torch.Tensor, yd: torch.Tensor, occ: torch.Tensor,
             params: list[float], grid: list[float]) -> torch.Tensor:
    return cuda_solver.density_cuda(xd, yd, params_of(params),
                                    grid_of(grid), occ)


@_density.register_fake
def _(xd, yd, occ, params, grid):
    return torch.empty_like(xd)


@torch.library.custom_op("bgf::forces_integrate", mutates_args=())
def _forces_integrate(
        xd: torch.Tensor, yd: torch.Tensor, vxd: torch.Tensor,
        vyd: torch.Tensor, rho_d: torch.Tensor,
        ref_xd: Optional[torch.Tensor], ref_yd: Optional[torch.Tensor],
        occ: torch.Tensor, params: list[float], cfg: list[float],
        grid: list[float], refless: bool, lanes: list[int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    return cuda_solver.forces_integrate_cuda(
        xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd, params_of(params),
        cfg_of(cfg), grid_of(grid), occ, refless=refless,
        disp_lanes=tuple(lanes) if lanes else None)


@_forces_integrate.register_fake
def _(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd, occ, params, cfg, grid,
      refless, lanes):
    return (*(torch.empty_like(xd) for _ in range(4)), xd.new_empty(()))


@torch.library.custom_op("bgf::mono_step", mutates_args=())
def _mono_step(
        xd: torch.Tensor, yd: torch.Tensor, vxd: torch.Tensor,
        vyd: torch.Tensor, ref_xd: torch.Tensor, ref_yd: torch.Tensor,
        occ: torch.Tensor, params: list[float], cfg: list[float],
        grid: list[float],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    return cuda_solver.mono_step_cuda(xd, yd, vxd, vyd, ref_xd, ref_yd,
                                      params_of(params), cfg_of(cfg),
                                      grid_of(grid), occ)


@_mono_step.register_fake
def _(xd, yd, vxd, vyd, ref_xd, ref_yd, occ, params, cfg, grid):
    return (*(torch.empty_like(xd) for _ in range(5)), xd.new_empty(()))


@torch.library.custom_op("bgf::reslot", mutates_args=())
def _reslot(
        xd: torch.Tensor, yd: torch.Tensor, vxd: torch.Tensor,
        vyd: torch.Tensor, idx_d: torch.Tensor, grid: list[float],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    return reslot_ops.reslot_cuda(xd, yd, vxd, vyd, idx_d, grid_of(grid))


@_reslot.register_fake
def _(xd, yd, vxd, vyd, idx_d, grid):
    g = grid_of(grid)
    return (*(torch.empty_like(xd) for _ in range(4)),
            torch.empty_like(idx_d), idx_d.new_empty((g.ny_pad, g.nx_pad)))


# ---- the wrappers' signatures over the operators -------------------------

def density_cuda(xd, yd, params: FluidParams, grid: GridSpec2D, occ,
                 out=None) -> torch.Tensor:
    if out is not None:
        raise ValueError("bgf::density writes a new plane: K1 into a given "
                         "plane (donate=True) is not an operator")
    return torch.ops.bgf.density(xd, yd, occ, pack_params(params),
                                 pack_grid(grid))


def forces_integrate_cuda(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                          params: FluidParams, cfg: IntegrateConfig,
                          grid: GridSpec2D, occ, refless: bool = False,
                          disp_lanes=None):
    if refless:     # not read: keep the placeholders out of the graph
        ref_xd = ref_yd = None
    return torch.ops.bgf.forces_integrate(
        xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd, occ, pack_params(params),
        pack_cfg(cfg), pack_grid(grid), refless,
        list(disp_lanes) if disp_lanes is not None else [])


def mono_step_cuda(xd, yd, vxd, vyd, ref_xd, ref_yd, params: FluidParams,
                   cfg: IntegrateConfig, grid: GridSpec2D, occ):
    return torch.ops.bgf.mono_step(xd, yd, vxd, vyd, ref_xd, ref_yd, occ,
                                   pack_params(params), pack_cfg(cfg),
                                   pack_grid(grid))


def reslot_cuda(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D):
    return torch.ops.bgf.reslot(xd, yd, vxd, vyd, idx_d, pack_grid(grid))
