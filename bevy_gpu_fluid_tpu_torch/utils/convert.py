"""Build the port's objects from the reference package's values.

Each function takes an object whose fields (the reference package's
``FluidParams``, ``IntegrateConfig``, ``GridSpec2D``, ``FluidState`` or
``DenseSim``) hold numpy arrays or anything ``numpy.asarray`` accepts, and
returns the port's counterpart with its tensors on ``device``.  Starting
both packages from the same values is how the tests compare them element
by element.  Nothing here imports the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..core.state import FluidState
from ..models.verlet_solver import DenseSim


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
