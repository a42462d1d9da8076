"""Build the port's objects from the reference package's values.

Each function takes an object whose fields (the reference package's
``FluidParams``, ``IntegrateConfig``, ``GridSpec2D``, ``FluidState``,
``DenseSim``, ``ShardSpec``, ``ShardedState`` or ``ShardedDenseSim``) hold
numpy arrays or anything ``numpy.asarray`` accepts, and returns the port's
counterpart with its tensors on ``device`` (the sharded ones: the
reference's [D, ...] stacks split into slab d on ``mesh.devices[d]``).
Starting both packages from the same values is how the tests compare them
element by element.  Nothing here imports the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..core.state import FluidState
from ..models.verlet_solver import DenseSim
from ..parallel.shard import ShardSpec, ShardedState
from ..parallel.shard_verlet import ShardedDenseSim, slabs_from_stacks


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _scalars(obj, cls):
    return cls(**{f.name: np.float32(np.asarray(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


def params_from(p) -> FluidParams:
    return _scalars(p, FluidParams)


def cfg_from(c) -> IntegrateConfig:
    return _scalars(c, IntegrateConfig)


def grid_from(g) -> GridSpec2D:
    return GridSpec2D(**{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(GridSpec2D)})


def state_from(s, device) -> FluidState:
    return FluidState(**{f.name: _t(getattr(s, f.name), device)
                         for f in dataclasses.fields(FluidState)
                         if f.name != "step"},
                      step=int(np.asarray(s.step)))


_HOST_INTS = ("age", "overflow", "lost", "rebin_count", "step", "readmitted")


def dense_sim_from(sim, device) -> DenseSim:
    kw = {}
    for f in dataclasses.fields(DenseSim):
        v = getattr(sim, f.name)
        kw[f.name] = int(np.asarray(v)) if f.name in _HOST_INTS \
            else _t(v, device)
    return DenseSim(**kw)


def spec_from(spec) -> ShardSpec:
    return ShardSpec(n_devices=int(spec.n_devices),
                     nx_local=int(spec.nx_local),
                     local_grid=grid_from(spec.local_grid),
                     global_x0=float(spec.global_x0),
                     capacity=int(spec.capacity), mig_cap=int(spec.mig_cap))


def _slabs(a, mesh) -> list:
    a = np.asarray(a)
    if a.shape[0] != mesh.n:
        raise ValueError(f"{a.shape[0]} slabs, the mesh has {mesh.n}")
    return [_t(a[d], dev) for d, dev in enumerate(mesh.devices)]


def sharded_state_from(s, mesh) -> ShardedState:
    """The port's per-slab ShardedState from the reference's [D, capacity]
    one."""
    return ShardedState(**{f.name: _slabs(getattr(s, f.name), mesh)
                           for f in dataclasses.fields(ShardedState)
                           if f.name != "step"},
                        step=int(np.asarray(s.step)))


def sharded_sim_from(sim, mesh) -> ShardedDenseSim:
    """The port's ShardedDenseSim from the reference's (every leaf [D, ...],
    the step a scalar)."""
    return ShardedDenseSim(**slabs_from_stacks(
        {f.name: np.asarray(getattr(sim, f.name))
         for f in dataclasses.fields(ShardedDenseSim)}, mesh.devices))
