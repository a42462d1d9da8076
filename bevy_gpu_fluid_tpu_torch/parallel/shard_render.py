"""Frames of a sharded run: per-slab field raster strips (port of
``bevy_gpu_fluid_tpu/parallel/shard_render.py``).

Each slab rasterizes its own part of the density field straight from its
resident planes (K4, ``render/raster.field_density_cuda``, with the slab's
world origin as data), after its ghost columns are refreshed from the
neighbours, so the pixels at a slab's edge see the particles across it and
the seam does not show.  The colour bounds are the min over wet pixels and
the max over all slabs (``SlabMesh.min`` / ``max``: the reference's
``pmin`` / ``pmax``), so the frame is seamless; the finished uint8 strips
are joined along the width on slab 0's device.  Particle state never leaves
the slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import FluidParams
from ..ops.binning import FAR
from ..render.raster import CYAN, _colormap_planes, _quantize, \
    field_density_cuda
from . import shard as sh
from .mesh import SlabMesh


def make_sharded_frame(params: FluidParams, spec: sh.ShardSpec,
                       mesh: SlabMesh, px_per_cell: int = 2,
                       mode: str = "density"):
    """Returns ``frame_fn(sim: ShardedDenseSim) -> uint8 [H, W, 3]`` (row 0
    = TOP, as the single-card ``field_frame``), W spanning all D *
    nx_local real cell columns at ``px_per_cell`` pixels each."""
    g = spec.local_grid
    nxl = spec.nx_local
    origins = [sh.slab_origin(spec, d) for d in range(spec.n_devices)]
    wet_rho = float(np.float32(0.05) * params.rho_0)

    def frame_fn(sim) -> torch.Tensor:
        planes = sh.fill_ghost_cols_multi(
            mesh, list(zip(sim.xd, sim.yd)), nxl, (FAR, FAR))
        rho = [field_density_cuda(xd, yd, params, g, px_per_cell, origin=o)
               for (xd, yd), o in zip(planes, origins)]
        wet = [r > wet_rho for r in rho]
        if mode == "const":
            colour = [[torch.where(w, c, 0.0) for c in CYAN] for w in wet]
        else:
            lo = mesh.min([torch.where(w, r, torch.inf).min()
                           for r, w in zip(rho, wet)])
            hi = mesh.max([r.max() for r in rho])
            colour = []
            for r, w, a, b in zip(rho, wet, lo, hi):
                inv = torch.where(b > a, 1.0 / (b - a), 0.0)
                colour.append([torch.where(w, p, 0.0)
                               for p in _colormap_planes((r - a) * inv)])
        dev = mesh.devices[0]
        strips = [torch.stack([_quantize(p) for p in c], dim=-1).to(dev)
                  for c in colour]
        return torch.cat(strips, dim=1)

    return frame_fn
