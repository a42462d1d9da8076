"""Scenes the port's kernel tests share, on the CPU and on the card (torch,
numpy and the port only: the card tests import no JAX)."""

import dataclasses

import numpy as np
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops.binning import FAR

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


# The planes the tiled kernels' premises are held on
# (tests/test_torch_stencil_tiles.py; tests/test_torch_exp.py holds the
# walk of T2 and T4 on some of them)
CFG = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID = vs.default_grid(0.045, -1.0, 2.5, y_max=6.0)
RCFG = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
RGRID = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
TILE_SCENES = ("init", "fused_rebin", "planar_rebin", "readmitted", "mono",
               "need", "need_readmitted")


def _kicked(steps, grid=GRID):
    state = bt.init_grid(24, 24, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 2.0))
    sess = vs.Session(state, PARAMS, CFG, grid, device="cpu")
    sess.run(steps)
    return sess


def _shifted(sim, seed):
    """The sim with live x moved by up to 0.01, so a rebin moves particles
    between cells; its references stay."""
    rng = np.random.default_rng(seed)
    shift = torch.from_numpy(rng.uniform(-0.01, 0.01, sim.xd.shape)
                             .astype(np.float32))
    return dataclasses.replace(
        sim, xd=torch.where(sim.xd < FAR * 0.5, sim.xd + shift, sim.xd))


def _to_need(sess, sim):
    """The DenseSim stepped on until the rebin trigger fires: the planes
    the next rebin (K3, or K6 + K7) receives."""
    for _ in range(200):
        if sess._need(sim):
            return sim
        sim = sess._pure_step(sim)
    raise AssertionError("the rebin trigger never fired")


def tile_scenes(names=TILE_SCENES) -> dict:
    """name -> (DenseSim, grid, cfg) for each of ``names``: the kicked 24 x
    24 block at init ("init"), after 12 steps and a fused or planar rebin
    of shifted planes ("fused_rebin", "planar_rebin"), stepped on to where
    the rebin trigger fires ("need"), and 12 steps on the 7-row-block grid
    where the Session steps on K5 ("mono"); the recovery scene (9
    particles in one cell at cap 8) after the rebin that readmits
    ("readmitted") and stepped on to the next trigger
    ("need_readmitted")."""
    names = set(names)
    out = {}
    if "init" in names:
        out["init"] = (_kicked(0).sim, GRID, CFG)
    if names & {"need", "fused_rebin", "planar_rebin"}:
        sess = _kicked(12)
        if "need" in names:
            out["need"] = (_to_need(sess, sess._pure_step(sess.sim)), GRID,
                           CFG)
        for name, planar in (("fused_rebin", False), ("planar_rebin", True)):
            if name not in names:
                continue
            rebin = vs.make_step_parts(PARAMS, CFG, GRID, n=sess.n,
                                       planar=planar)[1]
            sim = rebin(_shifted(sess.sim, seed=3))
            assert sim.rebin_count == sess.sim.rebin_count + 1
            out[name] = (sim, GRID, CFG)
    if names & {"readmitted", "need_readmitted"}:
        rsess = vs.Session(bt.init_grid(3, 3, 0.004, "cpu"), PARAMS, RCFG,
                           RGRID, device="cpu")
        assert rsess.suspended == 1
        sim = rsess.sim
        for _ in range(60):       # step until the rebin that readmits
            if rsess._need(sim):
                before = sim.readmitted
                sim = rsess._rebin(sim)
                if sim.readmitted > before:
                    break
            sim = rsess._pure_step(sim)
        assert sim.readmitted >= 1
        out["readmitted"] = (sim, RGRID, RCFG)
        if "need_readmitted" in names:
            out["need_readmitted"] = (_to_need(rsess, rsess._pure_step(sim)),
                                      RGRID, RCFG)
    if "mono" in names:
        assert RGRID.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS
        out["mono"] = (_kicked(12, RGRID).sim, RGRID, CFG)   # stepped on K5
    return out
