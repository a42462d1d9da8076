"""Spatial slab decomposition over a ``SlabMesh`` (port of
``bevy_gpu_fluid_tpu/parallel/shard.py``).

The domain is split along x into D vertical slabs of ``nx_local`` cell
columns, one per mesh device.  Each slab keeps the single-card dense layout
on its own local grid (``ShardSpec.local_grid``: the global grid with
``nx = nx_local`` and, per slab, its own world origin ``slab_origin``), and
its ghost columns 0 and ``nx_local + 1`` hold the neighbours' real edge
columns (``fill_ghost_cols_multi``) instead of FAR, so the single-card
kernels run on each slab unchanged.  The reference exchanges them with
``ppermute`` under ``shard_map``; here one process copies them between the
slabs (``parallel/mesh.py``).

Particle storage per slab is a fixed-capacity SoA (``ShardedState``: one
``[capacity]`` tensor per field and slab, an ``alive`` mask, the original
particle index in ``idx``, -1 = dead).  ``make_sharded_step`` is the eager
step over it (a binning every step, K1 + K8 per slab by default), with the
migration of particles that left their slab (at most ``mig_cap`` per
direction per step; losses counted in ``dropped``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.params import (FluidParams, GRAVITY_Y, GridSpec2D,
                           IntegrateConfig)
from ..core.state import FluidState
from ..models import cuda_solver
from ..models.verlet_solver import _WIDE_NX_PAD
from ..ops import integrator
from ..ops.binning import (FAR, Binned, cell_coords, from_dense_multi,
                           stable_rank, to_dense)
from ..ops.kernels import eos_pressure, self_density
from .mesh import SlabMesh

_f32 = np.float32
_DEAD_IDX = -1


@dataclasses.dataclass
class ShardedState:
    """Per-slab fixed-capacity SoA: each field a list of D tensors
    (float32 [capacity]; ``idx`` int32, the original particle index, -1 =
    dead; ``alive`` bool), slab d on the mesh's device d; ``step`` a host
    int."""

    x: list
    y: list
    vx: list
    vy: list
    rho: list
    p: list
    idx: list
    alive: list
    step: int = 0


@dataclasses.dataclass
class ShardDiag:
    """Per-slab diagnostics of one eager step, host ints: cell-capacity
    overflow, particles lost to the capacity or migration limits, live
    particles."""

    overflow: list
    dropped: list
    alive_count: list


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The static decomposition: the global grid split into ``n_devices``
    slabs of ``nx_local`` columns; per-slab particle capacity and migration
    buffer."""

    n_devices: int
    nx_local: int
    local_grid: GridSpec2D   # nx == nx_local, origin of slab 0
    global_x0: float         # world x of the global grid's origin
    capacity: int
    mig_cap: int

    @property
    def slab_width(self) -> float:
        return self.nx_local * self.local_grid.cell_size

    @staticmethod
    def build(h: float, x_min: float, x_max: float, y_max: float,
              n_devices: int, capacity: int, cap: int = 8,
              mig_cap: int | None = None) -> "ShardSpec":
        """The decomposition of ``GridSpec2D.from_bounds(h, ...)`` (``h``
        the cell size: the smoothing length times the skin factor for the
        Verlet solver).  Slabs of 4-row blocks from the single-card wide-grid
        width on (``verlet_solver.default_grid``'s rule), 8 below."""
        g = GridSpec2D.from_bounds(h=h, x_min=x_min, x_max=x_max, y_min=0.0,
                                   y_max=y_max, cap=cap)
        nx_local = -(-g.nx // n_devices)
        local = dataclasses.replace(g, nx=nx_local)
        if local.nx_pad >= _WIDE_NX_PAD:
            local = dataclasses.replace(local, row_block=4)
        return ShardSpec(n_devices=n_devices, nx_local=nx_local,
                         local_grid=local, global_x0=g.origin_x,
                         capacity=capacity,
                         mig_cap=mig_cap if mig_cap is not None
                         else max(256, capacity // 8))

    def global_grid(self) -> GridSpec2D:
        """The grid all slabs together cover (D * nx_local columns)."""
        return dataclasses.replace(self.local_grid,
                                   nx=self.nx_local * self.n_devices)


def slab_origin(spec: ShardSpec, d: int) -> tuple[np.float32, np.float32]:
    """World origin of slab d in float32, as the reference computes it:
    ``global_x0 + float32(d) * slab_width`` rounded at each operation."""
    ox = _f32(_f32(spec.global_x0) + _f32(_f32(d) * _f32(spec.slab_width)))
    return ox, _f32(spec.local_grid.origin_y)


def slab_grid(spec: ShardSpec, d: int) -> GridSpec2D:
    """Slab d's local grid with its own world origin."""
    ox, _ = slab_origin(spec, d)
    return dataclasses.replace(spec.local_grid, origin_x=float(ox))


def slab_of(x: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """Slab index of each position, int64: ``(x - global_x0) //
    slab_width`` in float32 (the reference's numpy floor division), clipped
    to [0, D-1]."""
    s = torch.div(x - float(_f32(spec.global_x0)),
                  float(_f32(spec.slab_width)), rounding_mode="floor")
    return torch.clamp(s, 0, spec.n_devices - 1).to(torch.int64)


def shard_state(state: FluidState, spec: ShardSpec,
                mesh: SlabMesh) -> ShardedState:
    """Partition a FluidState by x-slab into per-slab [capacity] buffers on
    the mesh's devices.  Slot i of a slab carries its ORIGINAL particle
    index in ``idx`` (in original order within the slab).  Raises
    ValueError if a slab would exceed its capacity."""
    M = spec.capacity
    slab = slab_of(state.x, spec)
    out = {k: [] for k in ("x", "y", "vx", "vy", "rho", "p", "idx",
                           "alive")}
    for d, dev in enumerate(mesh.devices):
        ids = torch.nonzero(slab == d).reshape(-1)
        k = ids.numel()
        if k > M:
            raise ValueError(f"slab {d} holds {k} > capacity {M}")
        for name in ("x", "y", "vx", "vy", "rho", "p"):
            buf = torch.full((M,), FAR if name in ("x", "y") else 0.0,
                             dtype=torch.float32, device=dev)
            buf[:k] = getattr(state, name)[ids].to(dev)
            out[name].append(buf)
        idx = torch.full((M,), _DEAD_IDX, dtype=torch.int32, device=dev)
        idx[:k] = ids.to(device=dev, dtype=torch.int32)
        alive = torch.zeros(M, dtype=torch.bool, device=dev)
        alive[:k] = True
        out["idx"].append(idx)
        out["alive"].append(alive)
    return ShardedState(step=state.step, **out)


def unshard_state(sharded: ShardedState) -> FluidState:
    """The live particles as one FluidState in slab order (for rendering or
    analysis), on slab 0's device; ``to_fluid_state`` gives original
    order."""
    dev = sharded.x[0].device
    pick = [a.to(dev) for a in sharded.alive]

    def cat(name):
        return torch.cat([t.to(dev)[m] for t, m in
                          zip(getattr(sharded, name), pick)])
    x = cat("x")
    z = torch.zeros_like(x)
    return FluidState(x=x, y=cat("y"), vx=cat("vx"), vy=cat("vy"), ax=z,
                      ay=z.clone(), rho=cat("rho"), p=cat("p"),
                      step=sharded.step)


def to_fluid_state(sharded: ShardedState, n: int) -> FluidState:
    """ORIGINAL-order FluidState (particle i of the input is particle i of
    the output, by the tracked ``idx``) on slab 0's device; particles lost
    to the capacity or migration limits come back at FAR with zero
    fields."""
    dev = sharded.x[0].device
    idx = torch.cat([t.to(dev) for t in sharded.idx])
    vals = torch.stack([torch.cat([t.to(dev) for t in getattr(sharded, k)])
                        for k in ("x", "y", "vx", "vy", "rho", "p")], dim=-1)
    out = torch.tensor([FAR, FAR, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                       device=dev).expand(n, 6).clone()
    ok = idx >= 0
    out[idx[ok].long()] = vals[ok]
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return FluidState(x=out[:, 0].contiguous(), y=out[:, 1].contiguous(),
                      vx=out[:, 2].contiguous(), vy=out[:, 3].contiguous(),
                      ax=z, ay=z.clone(), rho=out[:, 4].contiguous(),
                      p=out[:, 5].contiguous(), step=sharded.step)


@functools.cache
def _fill_columns(fills: tuple, device: torch.device) -> torch.Tensor:
    """[F, 1, 1] float32 fills on ``device``, made once (a tensor made from
    host values would sync the stream at every call)."""
    return torch.tensor(fills, dtype=torch.float32,
                        device=device).reshape(-1, 1, 1)


def fill_ghost_cols_multi(mesh: SlabMesh, fields: list, nxl: int,
                          fills, inplace: bool = False) -> list:
    """Every slab's ghost columns (lanes 0 and nxl+1) receive the
    neighbours' real edge columns (their lanes nxl and 1); a slab with no
    neighbour on a side receives that plane's fill.  ``fields[d]`` is slab
    d's tuple of F float32 planes and ``fills`` their F fills; the F edge
    columns travel stacked, one shift pair for all planes (the reference's
    ``_fill_ghost_cols_multi``).  At D = 1 the fields as they are.

    Two paths, by who owns the planes:

    * copying (``inplace=False``): new planes, the inputs left as they
      are.  The slab step's default posture takes it, so a ``ShardedDenseSim``
      kept from ``sess.sim`` stays a valid snapshot; it costs one new plane
      per input plane until the step's kernels have read them;
    * in place (``inplace=True``): the ghost columns of the given planes
      are overwritten and the same planes returned.  The slab step takes it
      when it owns its planes (``donate=True``, the memory-ceiling
      posture), for the density plane K1 has just written, and in the
      eager step for its freshly binned planes."""
    if mesh.n == 1:
        return [tuple(f) for f in fields]
    fillv = _fill_columns(tuple(float(v) for v in fills), fields[0][0].device)
    rights = [torch.stack([p[:, :, nxl] for p in f]) for f in fields]
    lefts = [torch.stack([p[:, :, 1] for p in f]) for f in fields]
    from_left = mesh.shift_fwd(rights, fillv)
    from_right = mesh.shift_bwd(lefts, fillv)
    out = []
    for d, f in enumerate(fields):
        planes = []
        for p, a, b in zip(f, from_left[d], from_right[d]):
            if inplace:
                p[:, :, 0] = a
                p[:, :, nxl + 1] = b
            else:        # one copy: the new ghost columns around the old
                p = torch.cat([a[:, :, None], p[:, :, 1:nxl + 1],
                               b[:, :, None], p[:, :, nxl + 2:]], dim=2)
            planes.append(p)
        out.append(tuple(planes))
    return out


def bin_slab(x, y, alive, grid: GridSpec2D) -> Binned:
    """``ops.binning.bin_particles`` of a slab's buffer on its grid (its
    world origin): dead entries go to the void cell id ``nx * ny`` (they
    rank after every real cell and never enter one), as the reference's
    ``bin_particles(alive=...)``; ``overflow`` counts live particles ranked
    at or beyond ``cap``."""
    cx, cy = cell_coords(x, y, grid)
    cid = torch.where(alive, cx + cy * grid.nx, grid.num_cells)
    cx = torch.where(alive, cx, 0)
    cy = torch.where(alive, cy, grid.ny)
    rank = stable_rank(cid)
    overflow = int(((rank >= grid.cap) & alive).sum())
    return Binned(cx=cx, cy=cy, rank=rank, overflow=overflow, grid=grid)


def _pack_migrants(fields, mask, E: int):
    """The first E masked entries (stable) into fixed [E] buffers: the
    packed fields (``fields`` as (tensor, fill) pairs), their validity, and
    the count of masked entries beyond E."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:E]
    ok = mask[order]
    packed = [torch.where(ok, f[order], fill) for f, fill in fields]
    return packed, ok, mask.sum() - ok.sum()


def make_sharded_step(params: FluidParams, cfg: IntegrateConfig,
                      spec: ShardSpec, mesh: SlabMesh, stencils=None):
    """The eager slab step ``fn(ShardedState) -> (ShardedState,
    ShardDiag)``: per slab a binning of its buffer, the position halo,
    density, the velocity and density halo, forces, the Euler step and
    bounce box, then the migration of particles that left their slab to
    the neighbour's buffer, compacted (stable) into the fixed capacity.
    ``stencils`` is the (density_fn, forces_fn) pair, e.g.
    ``grid_solver.XLA_STENCILS``; None takes K1 + K8
    (``cuda_solver.make_stencils``; the reference's None is its XLA
    pair)."""
    g = spec.local_grid
    D, M, E = spec.n_devices, spec.capacity, spec.mig_cap
    nxl = spec.nx_local
    if D != mesh.n:
        raise ValueError(f"spec has {D} slabs, mesh {mesh.n}")
    density_fn, forces_fn = (cuda_solver.make_stencils(g)
                             if stencils is None else stencils)
    self_rho = float(self_density(params))
    grids = [slab_grid(spec, d) for d in range(D)]
    dead_bits = torch.tensor(_DEAD_IDX, dtype=torch.int32).view(
        torch.float32).item()

    def step(s: ShardedState):
        binned, dense = [], []
        for d in range(D):
            alive = s.alive[d]
            xb = torch.where(alive, s.x[d], FAR)
            yb = torch.where(alive, s.y[d], FAR)
            b = bin_slab(xb, yb, alive, grids[d])
            binned.append(b)
            dense.append((to_dense(b, xb, FAR), to_dense(b, yb, FAR)))
        # halo 1: the neighbours' edge positions into the ghost columns
        dense = fill_ghost_cols_multi(mesh, dense, nxl, (FAR, FAR),
                                      inplace=True)
        rho = [density_fn(xd, yd, params) for xd, yd in dense]
        vel = []
        for d in range(D):
            alive, b = s.alive[d], binned[d]
            vel.append((to_dense(b, torch.where(alive, s.vx[d], 0.0), 0.0),
                        to_dense(b, torch.where(alive, s.vy[d], 0.0), 0.0),
                        rho[d]))
        # halo 2: the neighbours' edge velocities and densities
        vel = fill_ghost_cols_multi(mesh, vel, nxl, (0.0, 0.0, 0.0),
                                    inplace=True)
        moved, over = [], []
        for d in range(D):
            alive, b = s.alive[d], binned[d]
            (xd, yd), (vxd, vyd, rho_d) = dense[d], vel[d]
            ax_d, ay_d = forces_fn(xd, yd, vxd, vyd, rho_d, params)
            rho_g, ax_g, ay_g = from_dense_multi(
                b, [rho_d, ax_d, ay_d], [self_rho, 0.0, 0.0])
            r = torch.where(alive, rho_g, 0.0)
            p = torch.where(alive, eos_pressure(r, params), 0.0)
            ax = torch.where(alive, ax_g, 0.0)
            ay = torch.where(alive, ay_g + GRAVITY_Y, 0.0)
            x2, y2, vx2, vy2 = integrator.euler(s.x[d], s.y[d], s.vx[d],
                                                s.vy[d], ax, ay, cfg.dt)
            x2, y2, vx2, vy2 = integrator.boundaries(x2, y2, vx2, vy2, cfg)
            x2 = torch.where(alive, x2, FAR)
            y2 = torch.where(alive, y2, FAR)
            moved.append((x2, y2, vx2, vy2, r, p))
            over.append(b.overflow)
        if D == 1:
            x2, y2, vx2, vy2, r, p = moved[0]
            alive = s.alive[0]
            idx = torch.where(alive, s.idx[0], _DEAD_IDX)
            out = ShardedState(x=[x2], y=[y2], vx=[vx2], vy=[vy2], rho=[r],
                               p=[p], idx=[idx], alive=[alive],
                               step=s.step + 1)
            return out, ShardDiag(overflow=over, dropped=[0],
                                  alive_count=[int(alive.sum())])

        # migration: who left my slab, packed per direction
        sends_r, sends_l, stays, dropped = [], [], [], []
        for d in range(D):
            x2, y2, vx2, vy2, _, _ = moved[d]
            alive = s.alive[d]
            lo, _ = slab_origin(spec, d)
            hi = _f32(lo + _f32(spec.slab_width))
            go_left = alive & (x2 < float(lo)) & (d > 0)
            go_right = alive & (x2 >= float(hi)) & (d < D - 1)
            stays.append(alive & ~go_left & ~go_right)
            idx_f = s.idx[d].view(torch.float32)
            fields = [(x2, FAR), (y2, FAR), (vx2, 0.0), (vy2, 0.0),
                      (idx_f, dead_bits)]
            pl_, okl, dl = _pack_migrants(fields, go_left, E)
            pr_, okr, dr = _pack_migrants(fields, go_right, E)
            dropped.append(dl + dr)
            sends_r.append(torch.stack(pr_ + [okr.to(torch.float32)]))
            sends_l.append(torch.stack(pl_ + [okl.to(torch.float32)]))
        # slabs with no neighbour receive zeros: ok flag 0, dead
        recv_l = mesh.shift_fwd(sends_r, 0.0)
        recv_r = mesh.shift_bwd(sends_l, 0.0)

        def unpack(buf):
            ok = buf[5] > 0.5
            vals = [torch.where(ok, buf[i], FAR if i < 2 else 0.0)
                    for i in range(4)]
            ids = torch.where(ok, buf[4].contiguous().view(torch.int32),
                              _DEAD_IDX)
            return vals, ids, ok

        out = {k: [] for k in ("x", "y", "vx", "vy", "rho", "p", "idx",
                               "alive")}
        drops, counts = [], []
        for d in range(D):
            x2, y2, vx2, vy2, r, p = moved[d]
            stay = stays[d]
            inl, idl, okl = unpack(recv_l[d])
            inr, idr, okr = unpack(recv_r[d])
            all_alive = torch.cat([stay, okl, okr])
            zl, zr = torch.zeros_like(inl[0]), torch.zeros_like(inr[0])
            cat = {"x": (torch.where(stay, x2, FAR), inl[0], inr[0]),
                   "y": (torch.where(stay, y2, FAR), inl[1], inr[1]),
                   "vx": (torch.where(stay, vx2, 0.0), inl[2], inr[2]),
                   "vy": (torch.where(stay, vy2, 0.0), inl[3], inr[3]),
                   "rho": (torch.where(stay, r, 0.0), zl, zr),
                   "p": (torch.where(stay, p, 0.0), zl, zr),
                   "idx": (torch.where(stay, s.idx[d], _DEAD_IDX), idl,
                           idr)}
            order = torch.argsort((~all_alive).to(torch.int8),
                                  stable=True)[:M]
            new_alive = all_alive[order]
            drops.append(dropped[d] + all_alive.sum() - new_alive.sum())
            for k, parts in cat.items():
                v = torch.cat(parts)[order]
                if k == "idx":
                    v = torch.where(new_alive, v, _DEAD_IDX)
                out[k].append(v)
            out["alive"].append(new_alive)
            counts.append(new_alive.sum())
        host = torch.stack([torch.stack([a.to(mesh.devices[0]), c.to(
            mesh.devices[0])]) for a, c in zip(drops, counts)]).tolist()
        return (ShardedState(step=s.step + 1, **out),
                ShardDiag(overflow=over, dropped=[h[0] for h in host],
                          alive_count=[h[1] for h in host]))

    return step
