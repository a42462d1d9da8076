"""Checkpoint / resume (port of ``bevy_gpu_fluid_tpu/utils/checkpoint.py``).

npz files through numpy, with the reference package's key names
(``state.*``, ``sim.*``, ``grid.*``, ``params.*``, ``cfg.*``, ``meta.n``,
``meta.fp.*``), so an artifact of either package loads in the other.
Host ints (the step and the DenseSim counters) are stored as int32
scalars, tensors as arrays of their dtype.

Two granularities:

* ``save``/``load``: a per-particle ``FluidState`` (+ params/cfg), portable
  across grids and solvers;
* ``save_dense``/``load_dense``: the Verlet solver's RESIDENT ``DenseSim``
  with its grid geometry and the solver knobs' fingerprint, which a
  ``Session.restore`` continues bitwise.  ``load_dense`` writes planes the
  tile kernels will read, so it holds an artifact to their premise (live
  slots a prefix of each cell, dead slots exactly FAR with zero velocity,
  ``occ`` the planes' ``block_kmax3``) and raises ValueError where it
  fails, instead of letting K1, K2, K5, K6 and K8 mis-sum it.

* ``save_sharded``/``load_sharded``: the slab solver's RESIDENT
  ``ShardedDenseSim`` (``parallel/shard_verlet.py``) with its ``ShardSpec``,
  in the reference's layout (each field stacked over the slabs, [D, ...];
  the step counters as [D] arrays), which a ``ShardedSession.restore``
  continues bitwise; ``load_sharded`` holds each slab to the tile premise.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..core.state import FluidState


def _norm(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize so
    save('ckpt') / load('ckpt') round-trips."""
    return path if path.endswith(".npz") else path + ".npz"


def _np(v) -> np.ndarray:
    """A field as the reference stores it: tensors as arrays, host ints as
    int32 scalars, float32 host scalars as they are."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v)
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, dtype=np.int32)
    return np.asarray(v)


def _arrays(prefix: str, obj) -> dict:
    return {f"{prefix}{f.name}": _np(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _scalars(z, prefix: str, cls):
    """FluidParams / IntegrateConfig (float32 host scalars) from an npz, or
    None when it holds no ``prefix`` keys."""
    if not any(k.startswith(prefix) for k in z.files):
        return None
    return cls(**{f.name: np.float32(z[prefix + f.name])
                  for f in dataclasses.fields(cls)})


def save(path: str, state: FluidState, params: FluidParams | None = None,
         cfg: IntegrateConfig | None = None) -> None:
    """Write state (and optionally params/config) to an .npz file."""
    arrays = _arrays("state.", state)
    if params is not None:
        arrays.update(_arrays("params.", params))
    if cfg is not None:
        arrays.update(_arrays("cfg.", cfg))
    np.savez(_norm(path), **arrays)


def load(path: str, device="cuda") -> tuple[FluidState, FluidParams | None,
                                            IntegrateConfig | None]:
    """Read back (state on ``device``, params-or-None, cfg-or-None)."""
    with np.load(_norm(path)) as z:
        state = FluidState(**{
            f.name: (int(z["state.step"]) if f.name == "step" else
                     torch.from_numpy(np.array(z["state." + f.name]))
                     .to(device))
            for f in dataclasses.fields(FluidState)})
        return (state, _scalars(z, "params.", FluidParams),
                _scalars(z, "cfg.", IntegrateConfig))


# ---------------------------------------------------------------------------
# Resident-state checkpointing (DenseSim)
# ---------------------------------------------------------------------------

_GRID_META = ("origin_x", "origin_y", "cell_size", "nx", "ny", "cap",
              "row_block")
_GRID_INTS = {"nx", "ny", "cap", "row_block"}
_FP_PREFIX = "meta.fp."


def _grid_from(z, prefix: str) -> GridSpec2D:
    return GridSpec2D(**{k: (int(z[prefix + k]) if k in _GRID_INTS
                             else float(z[prefix + k])) for k in _GRID_META})


def load_fingerprint(path: str) -> dict | None:
    """The solver-knob fingerprint stored by ``save_dense`` (None for an
    artifact from before fingerprinting), as python scalars and strings."""
    with np.load(_norm(path)) as z:
        fp = {k[len(_FP_PREFIX):]: z[k][()] for k in z.files
              if k.startswith(_FP_PREFIX)}
    if not fp:
        return None
    return {k: (v.item() if getattr(v, "ndim", 0) == 0
                and v.dtype.kind in "biuf" else str(v))
            for k, v in fp.items()}


def check_fingerprint(saved: dict | None, supplied: dict,
                      where: str) -> None:
    """Raise ValueError where the knobs a restore supplies differ from a
    checkpoint's: such a continuation runs WITHOUT error but diverges from
    the saved run.  Only the keys the artifact saved are compared (an
    artifact of the reference package lacks ``code_dtype``); legacy
    artifacts (``saved`` None) are accepted unchecked."""
    if saved is None:
        return
    bad = {k: (saved[k], v) for k, v in supplied.items()
           if k in saved and saved[k] != v}
    if bad:
        detail = ", ".join(f"{k}: saved={s!r} supplied={v!r}"
                           for k, (s, v) in bad.items())
        raise ValueError(
            f"{where}: solver knobs do not match the checkpoint's "
            f"({detail}); continuing would silently diverge from the "
            f"saved run: re-supply the saved knobs (or re-save with the "
            f"new ones)")


def save_dense(path: str, sim, grid: GridSpec2D, params: FluidParams,
               cfg: IntegrateConfig, n: int,
               fingerprint: dict | None = None) -> None:
    """Snapshot a Verlet ``DenseSim`` (models/verlet_solver.py) with its
    grid geometry, physics and particle count: everything
    ``Session.restore`` needs to continue bitwise.  ``fingerprint`` records
    the solver knobs, so a restore can reject a mismatched continuation."""
    arrays = _arrays("sim.", sim)
    arrays.update({f"grid.{k}": np.asarray(getattr(grid, k))
                   for k in _GRID_META})
    arrays.update(_arrays("params.", params))
    arrays.update(_arrays("cfg.", cfg))
    arrays["meta.n"] = np.asarray(n)
    arrays.update({f"{_FP_PREFIX}{k}": np.asarray(v)
                   for k, v in (fingerprint or {}).items()})
    np.savez(_norm(path), **arrays)


def _check_tile_premise(sim, grid: GridSpec2D, bounds=None) -> None:
    """Raise ValueError unless the planes keep the tile kernels' premise:
    live slots (x < FAR/2) a prefix of each cell's slots, dead slots
    exactly FAR (x, y) with zero velocity and index -1, and ``occ`` the
    planes' ``block_kmax3`` (or, given ``bounds``, int32 [3, nb] tensors,
    at least each of them: a slab's occ must bound its neighbours' cells
    too)."""
    from ..ops import reslot as reslot_ops
    from ..ops.binning import FAR
    live = sim.xd < FAR * 0.5
    if bool((live[:, 1:, :] & ~live[:, :-1, :]).any()):
        raise ValueError("checkpoint planes: a live slot follows a dead one "
                         "in its cell (live slots must be a prefix)")
    dead = ~live
    if not (bool((sim.xd[dead] == FAR).all())
            and bool((sim.yd[dead] == FAR).all())
            and bool((sim.vxd[dead] == 0).all())
            and bool((sim.vyd[dead] == 0).all())
            and bool((sim.idx_d[dead] == -1).all())):
        raise ValueError("checkpoint planes: a dead slot is not FAR with "
                         "zero velocity and index -1")
    if bounds is not None:
        if not all(bool((sim.occ >= b).all()) for b in bounds):
            raise ValueError("checkpoint planes: occ does not bound the "
                             "slab's and its neighbours' cells (the slot "
                             "loops would miss live slots)")
    elif not torch.equal(sim.occ, reslot_ops.block_kmax3(sim.xd, grid)):
        raise ValueError("checkpoint planes: occ is not the planes' "
                         "block_kmax3 (the slot loops would miss live slots)")


def load_dense(path: str, device="cuda"):
    """Returns (DenseSim on ``device``, GridSpec2D, FluidParams,
    IntegrateConfig, n).  Artifacts without a spill buffer get an empty
    one; without ``occ`` (and ``disp2``), both are recomputed exactly from
    the planes.  Raises ValueError on planes that break the tile premise
    (``_check_tile_premise``)."""
    from ..models.verlet_solver import DenseSim, SPILL_CAP
    from ..ops import reslot as reslot_ops
    from ..ops.binning import FAR
    host = {"age", "overflow", "lost", "rebin_count", "step", "readmitted"}
    with np.load(_norm(path)) as z:
        grid = _grid_from(z, "grid.")
        kw = {k[4:]: (int(z[k]) if k[4:] in host else
                      torch.from_numpy(np.array(z[k])).to(device))
              for k in z.files if k.startswith("sim.")}
        params = _scalars(z, "params.", FluidParams)
        cfg = _scalars(z, "cfg.", IntegrateConfig)
        n = int(z["meta.n"])
    if "sidx" not in kw:       # pre-recovery snapshot: empty spill buffer
        f32 = dict(dtype=torch.float32, device=device)
        kw.update(sx=torch.full((SPILL_CAP,), FAR, **f32),
                  sy=torch.full((SPILL_CAP,), FAR, **f32),
                  svx=torch.zeros(SPILL_CAP, **f32),
                  svy=torch.zeros(SPILL_CAP, **f32),
                  sidx=torch.full((SPILL_CAP,), -1, dtype=torch.int32,
                                  device=device),
                  readmitted=0)
    if "occ" not in kw:        # pre-cached-bounds snapshot: recompute both
        kw["occ"] = reslot_ops.block_kmax3(kw["xd"], grid)
        ddx = kw["xd"] - kw["ref_xd"]
        ddy = kw["yd"] - kw["ref_yd"]
        kw["disp2"] = (ddx * ddx + ddy * ddy).amax()
    sim = DenseSim(**kw)
    _check_tile_premise(sim, grid)
    return sim, grid, params, cfg, n


# ---------------------------------------------------------------------------
# Resident-state checkpointing of the slab solver (ShardedDenseSim)
# ---------------------------------------------------------------------------

_SPEC_META = ("n_devices", "nx_local", "global_x0", "capacity", "mig_cap")


def save_sharded(path: str, sim, spec, params: FluidParams,
                 cfg: IntegrateConfig, n: int,
                 fingerprint: dict | None = None) -> None:
    """Snapshot a slab solver's ``ShardedDenseSim`` with its ``ShardSpec``,
    physics and particle count (the reference's ``save_sharded`` keys:
    every per-slab field stacked to [D, ...], ``step`` a scalar).
    ``fingerprint`` as in ``save_dense``."""
    D = sim.n_slabs
    arrays = {}
    for f in dataclasses.fields(sim):
        v = getattr(sim, f.name)
        if f.name == "step":
            arrays["sim.step"] = np.asarray(v, dtype=np.int32)
        elif isinstance(v, list):
            arrays[f"sim.{f.name}"] = np.stack([_np(t) for t in v])
        else:              # age, rebin count: the reference keeps one a slab
            arrays[f"sim.{f.name}"] = np.full((D,), v, dtype=np.int32)
    arrays.update({f"spec.local_grid.{k}": np.asarray(
        getattr(spec.local_grid, k)) for k in _GRID_META})
    arrays.update({f"spec.{k}": np.asarray(getattr(spec, k))
                   for k in _SPEC_META})
    arrays.update(_arrays("params.", params))
    arrays.update(_arrays("cfg.", cfg))
    arrays["meta.n"] = np.asarray(n)
    arrays.update({f"{_FP_PREFIX}{k}": np.asarray(v)
                   for k, v in (fingerprint or {}).items()})
    np.savez(_norm(path), **arrays)


def load_sharded(path: str, mesh):
    """Returns (ShardedDenseSim with slab d on ``mesh.devices[d]``,
    ShardSpec, FluidParams, IntegrateConfig, n).  Raises ValueError when
    the mesh has another slab count, or a slab's planes break the tile
    premise (``_check_tile_premise``; a slab's occ must bound its own cells
    and its neighbours' real cells)."""
    from ..ops import reslot as reslot_ops
    from ..ops.binning import FAR
    from ..parallel.shard import ShardSpec
    from ..parallel.shard_verlet import ShardedDenseSim, slabs_from_stacks
    with np.load(_norm(path)) as z:
        spec = ShardSpec(
            local_grid=_grid_from(z, "spec.local_grid."),
            **{k: (float(z[f"spec.{k}"]) if k == "global_x0"
                   else int(z[f"spec.{k}"])) for k in _SPEC_META})
        raw = {k[4:]: np.array(z[k]) for k in z.files if k.startswith("sim.")}
        params = _scalars(z, "params.", FluidParams)
        cfg = _scalars(z, "cfg.", IntegrateConfig)
        n = int(z["meta.n"])
    D = raw["xd"].shape[0]
    if D != mesh.n or D != spec.n_devices:
        raise ValueError(f"checkpoint has {D} slabs (spec "
                         f"{spec.n_devices}), the mesh {mesh.n}")
    g = spec.local_grid
    nxl = spec.nx_local
    kw = slabs_from_stacks(raw, mesh.devices)
    own = [reslot_ops.block_kmax3(x, g) for x in kw["xd"]]

    def real_bound(x):
        x = x.clone()
        x[:, :, 0] = FAR
        x[:, :, nxl + 1:] = FAR
        return reslot_ops.block_kmax3(x, g)
    nbr = [real_bound(x) for x in kw["xd"]]
    near = [[nbr[e].to(own[d].device) for e in (d - 1, d + 1)
             if 0 <= e < D] for d in range(D)]
    sim = ShardedDenseSim(**kw)
    for d in range(D):
        _check_tile_premise(SimpleNamespace(**sim.slab(d)), g,
                            bounds=[own[d]] + near[d])
    return sim, spec, params, cfg, n
