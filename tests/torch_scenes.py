"""Scenes the port's kernel tests share, on the CPU and on the card (torch,
numpy and the port only: the card tests import no JAX)."""

import numpy as np
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs

PARAMS = bt.FluidParams.demo()
EDGES_GRID = bt.GridSpec2D(origin_x=-0.135, origin_y=-0.135,
                           cell_size=0.0675, nx=126, ny=22, cap=8,
                           row_block=7)
EDGES_CFG = bt.IntegrateConfig.create(x_min=-0.135, x_max=8.3)


def edges_scene(device):
    """The ragged grid crowded at both edges: nx_pad 128 (not a multiple of
    the 30-column tile: the last tile is short and its window runs past
    nx_pad), row_block 7 (not a multiple of any tile's rows), cap 8; 750
    particles against the left wall, x in [-0.135, 0.2] (cell column 0,
    the plane's column 1, beside ghost column 0, whose left neighbour the
    first tile's window reaches through the wrap: column nx_pad - 1), so
    that cells there fill to cap, and 750 in the last real columns; 3
    Session steps.  Returns (sim, grid, cfg)."""
    rng = np.random.default_rng(7)
    state = bt.init_grid(50, 30, 0.04, device)
    half = state.n // 2
    x = np.concatenate([rng.uniform(-0.135, 0.2, half),
                        rng.uniform(7.45, 8.3, state.n - half)])
    y = rng.uniform(0.0, 1.0, state.n)
    state = state.replace(
        x=torch.from_numpy(x.astype(np.float32)).to(device),
        y=torch.from_numpy(y.astype(np.float32)).to(device))
    sess = vs.Session(state, PARAMS, EDGES_CFG, EDGES_GRID, device=device)
    sess.run(3)
    return sess.sim, EDGES_GRID, EDGES_CFG
