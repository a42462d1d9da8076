"""Deferred rebinning on the slabs of a ``SlabMesh`` (port of
``bevy_gpu_fluid_tpu/parallel/shard_verlet.py``).

Each slab keeps the single-card Verlet state (``models/verlet_solver.py``):
dense planes frozen between rebins, on its own local grid, with the
neighbours' real edge columns copied into its ghost columns.  A step is,
per slab: the position and velocity halo (``shard.fill_ghost_cols_multi``),
K1 (density), the density halo, and K2 (forces + integrate + trigger) with
its displacement max over the slab's real columns only (``disp_lanes``).

The rebin is COLLECTIVE: the trigger is the any over the slabs' ``disp2``
(one host sync per step for all slabs, ``SlabMesh.any``) or the bins' age,
and every slab rebins together:

1. the ghost columns of x and idx are cleared (they hold the neighbour's
   particles), and the local reslot (K3, or the planar K6 + 5 x K7) runs
   with its x clip widened to [-1, nx_local] and the slab's world origin,
   so a particle that left the slab is CAPTURED in the ghost column of its
   exit side;
2. the two capture columns move to the neighbours (one shift pair), and
   each slab merges what it receives into its edge cells, at ranks after
   their occupants, up to ``cap`` (``merge_col``); the edge slabs fold
   their own outward captures back into their edge cells (the bounce box
   clamps x into the domain, so those are boundary-exact positions, not
   exits);
3. the slot bounds ``occ`` are refreshed, each slab's maxed with both
   neighbours' (a ghost column holds up to the neighbour's occupancy).

Overflow RECOVERY (``n`` given): a particle that loses its slot at a rebin
(a full cell at the reslot, or at the edge merge) parks in its slab's spill
buffer and re-admits at a later rebin when its cell has room, it satisfies
the skin invariant |v| dt <= skin_half, and it lies inside the slab.  At
D = 1 the rebin is the single-card one (plain clip, nothing to capture).

Unlike the reference, a rebin zeroes ``disp2`` (the reference keeps the
stale value under the ref-based trigger, ROADMAP S1; the pure step that
follows overwrites it, so the trajectory is the same).  The counters are
host ints per slab; a rebin reads them back in two syncs for all slabs.

The postures of very large N per slab are the single card's, slab by
slab (``make_sharded_verlet_step``): the unfused step (``fused=False``
with a ``stencils`` pair), the chunked and generator inits, the refless
trigger, owned planes (``donate``: the halo in place, K1 into the dead
rho, the planar rebin consuming its inputs); the segmented driver runs
``verlet_solver.run_segmented`` over the slab step's pieces.
``slab_default`` chooses the postures from the memory each slab gets of
its card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import FluidParams, IntegrateConfig
from ..core.state import FluidState
from ..models import cuda_solver
from ..models.verlet_solver import (_chunk_init_body, _chunk_init_carry,
                                    _first_k, _found_in_window,
                                    _ref_placeholder, _skin, _spill_collect,
                                    planar_rebin_default)
from ..ops import reslot as reslot_ops
from ..ops.binning import FAR, inv_cell, to_dense
from ..ops.kernels import eos_pressure, self_density
from . import shard as sh
from .mesh import SlabMesh

SPILL_CAP = 256  # default per-slab spill-buffer entries

_PLANE_FILLS = reslot_ops.PLANE_FILLS   # empty x, y, vx, vy, idx slots


@dataclasses.dataclass
class ShardedDenseSim:
    """The slabs' dense-resident state: every tensor field a list of D
    tensors (slab d on the mesh's device d), every counter a list of D host
    ints, and the step counters host ints shared by all slabs.

    xd/yd/vxd/vyd/rho_d/ref_xd/ref_yd: float32 [ny_pad, cap, nx_pad] per
              slab, as ``verlet_solver.DenseSim``'s
    idx_d:    int32 original (global) particle index per slot, -1 = empty:
              identity through migration and rebinning
    occ:      int32 [3, n_row_blocks] slot-loop bounds per slab, maxed with
              both neighbours' at each rebin
    disp2:    float32 0-dim per slab: the max squared displacement of its
              real columns from the rebin reference (K2's, last step)
    sx/sy/svx/svy/sidx: per-slab spill buffers ([spill_cap]; sidx -1 =
              empty)
    alive:    live particles in each slab's real columns
    overflow, lost, dropped, readmitted: cumulative per slab (capacity
              drops at the reslot, window misses, drops at the edge merge,
              re-admissions)
    age, rebin_count, step: steps since the last rebin, rebins (1 for the
              init), steps
    """

    xd: list
    yd: list
    vxd: list
    vyd: list
    rho_d: list
    ref_xd: list
    ref_yd: list
    idx_d: list
    occ: list
    disp2: list
    sx: list
    sy: list
    svx: list
    svy: list
    sidx: list
    alive: list
    overflow: list
    lost: list
    dropped: list
    readmitted: list
    age: int = 0
    rebin_count: int = 1
    step: int = 0

    @property
    def n_slabs(self) -> int:
        return len(self.xd)

    @property
    def suspended(self) -> int:
        """Particles parked in the spill buffers (all slabs)."""
        return sum(int((s >= 0).sum()) for s in self.sidx)

    def slab(self, d: int) -> dict:
        """Slab d's tensors and counters by field name."""
        return {f.name: (getattr(self, f.name)[d]
                         if isinstance(getattr(self, f.name), list)
                         else getattr(self, f.name))
                for f in dataclasses.fields(self)}


_SHARED_INTS = ("age", "rebin_count")   # one host int for all slabs
_SLAB_INTS = ("alive", "overflow", "lost", "dropped", "readmitted")


def slabs_from_stacks(stacks: dict, devices) -> dict:
    """``ShardedDenseSim`` fields from the reference's layout (``stacks``:
    numpy arrays by field name, each [D, ...]; ``step`` a scalar; age and
    rebin count per slab, equal on every slab): tensors split into slab d
    on ``devices[d]``, counters as lists of host ints.  Fields absent from
    ``stacks`` stay absent."""
    out = {}
    for name, v in stacks.items():
        if name in _SHARED_INTS:
            out[name] = int(np.max(v))
        elif name == "step":
            out[name] = int(v)
        elif name in _SLAB_INTS:
            out[name] = [int(c) for c in v]
        else:
            if len(v) != len(devices):
                raise ValueError(f"{name}: {len(v)} slabs, the mesh has "
                                 f"{len(devices)}")
            out[name] = [torch.from_numpy(np.array(v[d])).to(dev)
                         for d, dev in enumerate(devices)]
    return out


def _clear_ghost_cols(a: torch.Tensor, nxl: int, fill,
                      inplace: bool = False) -> torch.Tensor:
    """The plane with ghost columns 0 and nxl+1 set to fill: a copy, or
    the plane itself written in place when ``inplace`` (owned planes)."""
    if not inplace:
        a = a.clone()
    a[:, :, 0] = fill
    a[:, :, nxl + 1] = fill
    return a


def _count_live(xd: torch.Tensor) -> torch.Tensor:
    return (xd < FAR * 0.5).sum()


def _real_cols(a: torch.Tensor, nxl: int) -> torch.Tensor:
    return a[:, :, 1:nxl + 1]


def _dead_column_fill(device) -> torch.Tensor:
    """[5, 1, 1] fills of the (x, y, vx, vy, idx-as-float32-bits) edge
    columns a slab with no neighbour receives: FAR, FAR, 0, 0, -1."""
    bits = torch.tensor([np.float32(FAR).view(np.int32),
                         np.float32(FAR).view(np.int32), 0, 0, -1],
                        dtype=torch.int32, device=device)
    return bits.view(torch.float32).reshape(5, 1, 1)


def merge_col(planes, lane: int, src, base_cnt, cap: int):
    """Append the occupants of ``src`` (x, y, vx, vy, idx planes [ny_pad,
    cap], x FAR = dead) into column ``lane`` of the dense planes (x, y, vx,
    vy, idx; written in place) at ranks continuing from ``base_cnt`` (the
    cells' match counts [ny_pad]), in slot order.  Returns the bool mask
    [ny_pad, cap] of the ``src`` entries beyond the cell's capacity (the
    receiver's recovery collects them).  The reference appends slot by slot
    with a running count; here every source slot's rank comes at once from
    a cumulative count, and each target slot gathers the one source slot
    ranked there (ranks of live slots are distinct): the same planes."""
    live = src[0] < FAR * 0.5
    n = live.to(torch.int64)
    rank = torch.clamp_max(base_cnt, cap).to(torch.int64)[:, None] \
        + torch.cumsum(n, dim=1) - n
    dest = torch.where(live, rank, -1)
    hit = dest[:, :, None] == torch.arange(cap, device=dest.device)
    source = hit.to(torch.int32).argmax(dim=1)         # [ny_pad, cap]
    taken = hit.any(dim=1)
    for p, s in zip(planes, src):
        p[:, :, lane] = torch.where(taken, s.gather(1, source),
                                    p[:, :, lane])
    return live & (rank >= cap)


def _found_in_exports(pidx_d, exi_l, exi_r):
    """Per pre-rebin slot: is its particle index in an export column (left
    or right) within one row of its own row?  (An exported id sits in the
    export column at its post-reslot row, +-1 of its pre row.)"""
    R = pidx_d.shape[0]
    exp = F.pad(torch.stack([exi_l, exi_r]), (0, 0, 1, 1), value=-1)
    found = torch.zeros(pidx_d.shape, dtype=torch.bool, device=pidx_d.device)
    for s in range(6):
        ex = exp[s // 3, s % 3:s % 3 + R, :]                 # [R, cap]
        found |= (pidx_d[:, :, None, :] == ex[:, None, :, None]).any(dim=2)
    return found


def _sh_admit(planes, spill, readmitted: int, grid, ox, vmax2):
    """Recovery's RE-ADMIT on one slab: spill entries that satisfy the skin
    invariant and lie inside the slab go into their cells' free slots, at
    ranks after the cells' live occupants, oldest first; the planes (the
    fresh rebin outputs) are written in place.  Returns (spill,
    readmitted)."""
    xd = planes[0]
    sx, sy, svx, svy, sidx = spill
    cap = grid.cap
    K = sx.shape[0]
    valid = sidx >= 0
    occ_cell = (xd < FAR * 0.5).sum(dim=1)
    inv = float(inv_cell(grid))
    oy = float(np.float32(grid.origin_y))
    gx = torch.where(valid, sx, float(ox))
    gy = torch.where(valid, sy, oy)
    ccx = torch.floor((gx - float(ox)) * inv).to(torch.int64)
    ccy = torch.floor((gy - oy) * inv).to(torch.int64)
    elig = (valid & (svx * svx + svy * svy <= float(vmax2))
            & (ccx >= 0) & (ccx < grid.nx) & (ccy >= 0) & (ccy < grid.ny))
    row = torch.clamp(ccy, 0, grid.ny - 1) + grid.row0
    col = torch.clamp(ccx, 0, grid.nx - 1) + 1
    base = occ_cell[row, col]
    cid = row * grid.nx_pad + col
    io = torch.arange(K, device=sx.device)
    rank = ((cid[:, None] == cid[None, :]) & elig[None, :]
            & (io[None, :] < io[:, None])).sum(dim=1)
    admit = elig & (base + rank < cap)
    r, s, c = row[admit], (base + rank)[admit], col[admit]
    for plane, vals in zip(planes, spill):
        plane[r, s, c] = vals[admit]
    readmitted += int(admit.sum())
    spill = tuple(torch.where(admit, fill, v)
                  for v, fill in zip(spill, _PLANE_FILLS))
    return spill, readmitted


def _sh_recover(planes, merges, spill, readmitted: int, grid, ox, vmax2):
    """The rest of recovery on one slab at a rebin, after the reslot's
    losses are collected: COLLECT the edge merges' drops (``merges``, a
    list of (drop mask, source planes)) into the spill buffer, then
    RE-ADMIT (``_sh_admit``)."""
    for dmask, src in merges:
        spill = _spill_collect(dmask, src, spill)
    return _sh_admit(planes, spill, readmitted, grid, ox, vmax2)


class ShardedSteps:
    """The sharded solver's pieces: ``init`` (a ShardedState, or the
    initial step on the generator path), ``pure_step(sim)`` (the kernels
    between rebins), ``rebin(sim)`` (the collective rebin), ``need(sim)``
    (the trigger, a host bool) and ``step(sim)`` (rebin if needed, then
    the pure step)."""

    def __init__(self, init, pure_step, rebin, need):
        self.init = init
        self.pure_step = pure_step
        self.rebin = rebin
        self.need = need

    def step(self, sim: ShardedDenseSim) -> ShardedDenseSim:
        if self.need(sim):
            sim = self.rebin(sim)
        return self.pure_step(sim)


def make_sharded_verlet_step(params: FluidParams, cfg: IntegrateConfig,
                             spec: sh.ShardSpec, mesh: SlabMesh,
                             max_age: int = 64, n: int | None = None,
                             spill_cap: int = SPILL_CAP,
                             planar: bool | None = None, *,
                             stencils=None, fused: bool = True,
                             init_chunks: int | None = None,
                             refless: bool = False, gen=None,
                             gen_n: int | None = None,
                             donate: bool = False,
                             kernels=None) -> ShardedSteps:
    """The slab step.  Requires ``spec.local_grid.cell_size > params.h``;
    ``n`` (the global particle count) arms overflow recovery.

    The step: ``fused=True`` (the default) runs K1 + K2 per slab;
    ``fused=False`` the ``stencils`` pair (None: ``grid_solver.
    XLA_STENCILS``, as the reference; ``cuda_solver.make_stencils(g)`` for
    K1 + K8), then Euler, bounce and the trigger's max over the slab's real
    columns as torch ops (``cuda_solver.integrate_into``).  The rebin: the
    fused reslot K3 or, with ``planar`` (None: ``slab_default`` on the
    memory each slab gets of its card), the planar K6 + 5 x K7 (bitwise
    the same rebin).

    The memory-ceiling postures (the reference's, each the sharded twin of
    the single card's in ``models/verlet_solver.py``):

    * ``init_chunks=K``: each slab's dense planes built from K chunks of
      its buffer (``verlet_solver._chunk_init_body`` on the slab's grid):
      O(capacity / K) sort transients, bitwise the sort-based init;
    * ``gen``/``gen_n``: the GENERATOR init, ``init(step)``: each slab
      scans the global index range [0, gen_n) in ``init_chunks`` (or 16)
      chunks of ``gen(gi)`` -> (x, y, vx, vy) and keeps the particles of
      its slab (``shard.slab_of``, ``shard_state``'s own test), so neither
      the [N] state nor the [capacity] buffers ever exist; bitwise
      ``shard_state`` + the chunked init;
    * ``refless=True``: the REFLESS trigger.  The reference planes become
      (1, 1, 1) placeholders (two plane-footprints less per slab), K2 (or
      the unfused tail) reports the step's largest move over the real
      columns and each slab's ``disp2`` sums its square roots, compared
      with half the skin unsquared.  Rebins fire somewhat earlier: not
      bitwise the ref-based trigger;
    * ``donate=True``: the step OWNS the planes of the sim it is given.
      The halo writes the ghost columns in place, K1 writes the new rho
      into the dead rho plane, the rebin clears the ghost columns in place,
      each slab's old planes are freed as soon as its new ones exist, and
      the planar rebin consumes them one by one (``reslot.apply_planes``),
      its losses read off the code (``reslot.taken_mask``).  A sim kept
      from before the step is invalidated.  If that rebin fails before it
      consumed an input plane, the sim gets slab 0's planes back (the
      rebin is still due); after that the error says the sim is lost.  Bitwise the copying posture,
      but for the reference planes' ghost columns (ref-based: they alias
      the positions, which the halo now writes; nothing reads them).

    The segmented driver (``verlet_solver.run_segmented`` over
    ``pure_step``, ``need`` and ``rebin``) is two host loops, the standard
    trajectory bit for bit: the reference's donor-chain rebin works
    around XLA's donation pairing and has no counterpart here.

    ``kernels`` stands in for K1's and K2's wrappers in the step (as
    ``verlet_solver.make_step_parts``'s: ``kernels.ops`` for
    ``torch.export``)."""
    from ..models import grid_solver
    ks = cuda_solver if kernels is None else kernels
    g = spec.local_grid
    D = spec.n_devices
    nxl = spec.nx_local
    cap = g.cap
    if D != mesh.n:
        raise ValueError(f"spec has {D} slabs, mesh {mesh.n}")
    if planar is None:
        planar = slab_default(planar_rebin_default, g, mesh, donate)
    if not fused:
        density_fn, forces_fn = (grid_solver.XLA_STENCILS
                                 if stencils is None else stencils)
    rho_into = donate and (fused or getattr(density_fn, "takes_out", False))
    lean = donate and planar     # the planar rebin consumes owned planes
    # D > 1: the clip widened to [-1, nx_local] captures slab exits in the
    # ghost columns.  D = 1: the plain clip (the bounce box keeps every
    # particle in the slab, so there is nothing to capture).
    clip = (-1, nxl) if D > 1 else (0, nxl - 1)
    origins = [sh.slab_origin(spec, d) for d in range(D)]
    grids = [sh.slab_grid(spec, d) for d in range(D)]
    skin_half = _skin(params, g)
    thr = float(skin_half) if refless else float(skin_half * skin_half)
    q = skin_half / cfg.dt
    vmax2 = q * q
    disp_lanes = (1, nxl + 1)
    dead_col = [_dead_column_fill(dev) for dev in mesh.devices]
    halo_fills = (FAR, FAR, 0.0, 0.0)

    def reslot(xd, yd, vxd, vyd, idx_d, d):
        if planar:
            return reslot_ops.reslot_planar(xd, yd, vxd, vyd, idx_d, g,
                                            torch.int32, *clip, origins[d])
        return reslot_ops.reslot_cuda(xd, yd, vxd, vyd, idx_d, g, *clip,
                                      origins[d])

    def refs(xds, yds):
        """The rebin references of new position planes, per slab."""
        if refless:
            return ([_ref_placeholder(x.device) for x in xds],
                    [_ref_placeholder(x.device) for x in xds])
        return list(xds), list(yds)

    def occ_of(xds):
        """Each slab's ``block_kmax3`` maxed with both neighbours' (a ghost
        column holds up to the neighbour's occupancy after the halo)."""
        occ = [reslot_ops.block_kmax3(xd, g) for xd in xds]
        if D == 1:
            return occ
        left = mesh.shift_fwd(occ, 0)
        right = mesh.shift_bwd(occ, 0)
        return [torch.maximum(o, torch.maximum(a, b))
                for o, a, b in zip(occ, left, right)]

    def host(per_slab):
        """Per-slab lists of 0-dim tensors -> per-slab lists of ints, in
        one sync."""
        dev = mesh.devices[0]
        return torch.stack([torch.stack([v.to(dev).to(torch.int64)
                                         for v in vals])
                            for vals in per_slab]).tolist()

    def chunks_of_state(s: sh.ShardedState, d: int):
        """Slab d's buffer in ``init_chunks`` slices (dead entries idx -1)."""
        alive = s.alive[d]
        m = alive.shape[0]
        c = -(-m // init_chunks)
        for lo in range(0, m, c):
            a = alive[lo:lo + c]
            yield (torch.where(a, s.x[d][lo:lo + c], FAR),
                   torch.where(a, s.y[d][lo:lo + c], FAR),
                   torch.where(a, s.vx[d][lo:lo + c], 0.0),
                   torch.where(a, s.vy[d][lo:lo + c], 0.0),
                   torch.where(a, s.idx[d][lo:lo + c], -1))

    def chunks_of_gen(d: int):
        """The global index range in chunks, slab d's particles kept."""
        dev = mesh.devices[d]
        c = -(-gen_n // (init_chunks or 16))
        for lo in range(0, gen_n, c):
            gi = torch.arange(lo, min(lo + c, gen_n), device=dev)
            x, y, vx, vy = (a.to(dev) for a in gen(gi))
            mine = sh.slab_of(x, spec) == d
            yield (torch.where(mine, x, FAR), torch.where(mine, y, FAR),
                   torch.where(mine, vx, 0.0), torch.where(mine, vy, 0.0),
                   torch.where(mine, gi.to(torch.int32), -1))
            del x, y, vx, vy, mine, gi

    def init_chunked(chunks, d: int) -> dict:
        carry = _chunk_init_carry(g, spill_cap, mesh.devices[d])
        for chunk in chunks:
            _chunk_init_body(carry, chunk, grids[d], n is not None)
        return dict(xd=carry["xd"], yd=carry["yd"], vxd=carry["vxd"],
                    vyd=carry["vyd"], idx_d=carry["idx_d"],
                    spill=carry["spill"], overflow=carry["overflow"])

    def init_sorted(s: sh.ShardedState, d: int) -> dict:
        alive = s.alive[d]
        x, y, vx, vy, idx = s.x[d], s.y[d], s.vx[d], s.vy[d], s.idx[d]
        xb = torch.where(alive, x, FAR)
        yb = torch.where(alive, y, FAR)
        b = sh.bin_slab(xb, yb, alive, grids[d])
        # the binning's capacity drops go to the spill (recovery armed)
        m = x.shape[0]
        dropped = alive & (b.rank >= cap) if n is not None \
            else torch.zeros_like(alive)
        dpos = _first_k(dropped, spill_cap)
        dv = dpos < m
        ds = torch.clamp_max(dpos, m - 1)
        return dict(
            xd=to_dense(b, xb, FAR), yd=to_dense(b, yb, FAR),
            vxd=to_dense(b, torch.where(alive, vx, 0.0), 0.0),
            vyd=to_dense(b, torch.where(alive, vy, 0.0), 0.0),
            idx_d=to_dense(b, torch.where(alive, idx, -1), -1),
            spill=tuple(torch.where(dv, v[ds], fill) for v, fill in
                        zip((x, y, vx, vy, idx), _PLANE_FILLS)),
            overflow=b.overflow)

    def init(s) -> ShardedDenseSim:
        """A ShardedState into the slabs' dense state; on the generator
        path ``s`` is the initial step (an int)."""
        slabs = []
        for d in range(D):
            if gen is not None:
                slabs.append(init_chunked(chunks_of_gen(d), d))
            elif init_chunks is not None:
                slabs.append(init_chunked(chunks_of_state(s, d), d))
            else:
                slabs.append(init_sorted(s, d))
        out = {k: [p[k] for p in slabs]
               for k in ("xd", "yd", "vxd", "vyd", "idx_d")}
        xds = out["xd"]
        ref_x, ref_y = refs(xds, out["yd"])
        spill = list(zip(*[p["spill"] for p in slabs]))
        return ShardedDenseSim(
            **out, sx=list(spill[0]), sy=list(spill[1]), svx=list(spill[2]),
            svy=list(spill[3]), sidx=list(spill[4]),
            rho_d=[torch.zeros_like(x) for x in xds], ref_xd=ref_x,
            ref_yd=ref_y, occ=occ_of(xds),
            disp2=[torch.zeros((), dtype=torch.float32, device=dev)
                   for dev in mesh.devices],
            alive=[v[0] for v in host([[_count_live(x)] for x in xds])],
            overflow=[p["overflow"] for p in slabs], lost=[0] * D,
            dropped=[0] * D, readmitted=[0] * D,
            step=int(s) if gen is not None else s.step)

    def need(sim: ShardedDenseSim) -> bool:
        """Rebin before this step's kernels: some slab's particle outran
        half the skin (its ``disp2``, K2's of the last step; refless: the
        summed step maxima, unsquared), or the bins aged out.  One host
        sync for all slabs."""
        if sim.age >= max_age:
            return True
        return mesh.any([d2 > thr for d2 in sim.disp2])

    def pure_step(sim: ShardedDenseSim) -> ShardedDenseSim:
        if not donate:      # the given sim stays a snapshot
            sim = dataclasses.replace(
                sim, xd=list(sim.xd), yd=list(sim.yd), vxd=list(sim.vxd),
                vyd=list(sim.vyd), rho_d=list(sim.rho_d),
                disp2=list(sim.disp2))
        planes = sh.fill_ghost_cols_multi(
            mesh, list(zip(sim.xd, sim.yd, sim.vxd, sim.vyd)), nxl,
            halo_fills, inplace=donate)
        rho = []
        for d, (p, occ) in enumerate(zip(planes, sim.occ)):
            out = sim.rho_d[d] if rho_into else None
            if fused:
                rho.append(ks.density_cuda(p[0], p[1], params, g, occ,
                                           out=out))
            else:
                kw = {} if out is None else {"out": out}
                rho.append(density_fn(p[0], p[1], params, occ=occ, **kw))
        if D > 1:
            rho = [r[0] for r in sh.fill_ghost_cols_multi(
                mesh, [(r,) for r in rho], nxl, (0.0,), inplace=True)]
        for d in range(D):
            x, y, vx, vy = planes[d]
            planes[d] = None
            occ = sim.occ[d]
            if fused:
                new = ks.forces_integrate_cuda(
                    x, y, vx, vy, rho[d], sim.ref_xd[d], sim.ref_yd[d],
                    params, cfg, g, occ, refless=refless,
                    disp_lanes=disp_lanes)
            else:
                ax, ay = forces_fn(x, y, vx, vy, rho[d], params, occ=occ)
                new = cuda_solver.integrate_into(
                    x, y, vx, vy, ax, ay, sim.ref_xd[d], sim.ref_yd[d], cfg,
                    refless=refless, lanes=disp_lanes)
                del ax, ay
            del x, y, vx, vy      # owned: slab d's old planes die here
            sim.xd[d], sim.yd[d], sim.vxd[d], sim.vyd[d] = new[:4]
            sim.rho_d[d] = rho[d]
            sim.disp2[d] = (sim.disp2[d] + torch.sqrt(new[4]) if refless
                            else new[4])
            del new
        sim.age += 1
        sim.step += 1
        return sim

    def consume_planar(sim: ShardedDenseSim, d: int, before, spill):
        """The owned planar rebin of slab d (ghost columns already
        cleared; ``before`` its live count): K6, the losses read off the
        code and collected while the old planes live, then 5 x K7, each old
        plane freed after its copy.  Returns (planes, cnt, spill)."""
        old = [sim.xd[d], sim.yd[d], sim.vxd[d], sim.vyd[d], sim.idx_d[d]]
        sim.xd[d] = sim.yd[d] = sim.vxd[d] = sim.vyd[d] = None
        sim.idx_d[d] = sim.ref_xd[d] = sim.ref_yd[d] = None
        try:
            occ = reslot_ops.block_kmax3(old[0], g)
            code, cnt = reslot_ops.select_cuda(old[0], old[1], g, occ,
                                               torch.int32, *clip, origins[d])
            if n is not None:
                alive, captured, spilled = host([[
                    before, torch.clamp_max(cnt, cap).sum(),
                    (sim.sidx[d] >= 0).any()]])[0]
                if alive - captured > 0 or spilled:
                    gone = (old[4] >= 0) & ~reslot_ops.taken_mask(code, cap)
                    spill = _spill_collect(gone, old, spill)
                    del gone
            return reslot_ops.apply_planes(old, code, occ, g), cnt, spill
        except BaseException as exc:
            if d > 0 or any(p is None for p in old):
                raise RuntimeError(
                    f"owned planar rebin failed on slab {d} after consuming "
                    "input planes; the ShardedDenseSim is lost (restore a "
                    "checkpoint)") from exc
            # nothing consumed: hand the planes back.  The rebin is still
            # due, so the next step rebins before it reads the references.
            sim.xd[d], sim.yd[d], sim.vxd[d], sim.vyd[d], sim.idx_d[d] = old
            (sim.ref_xd[d],), (sim.ref_yd[d],) = refs(old[:1], old[1:2])
            raise

    def rebin(sim: ShardedDenseSim) -> ShardedDenseSim:
        slabs, stats, exports, merges = [], [], [], []
        if not donate:      # the given sim stays a snapshot
            sim = dataclasses.replace(sim, xd=list(sim.xd),
                                      idx_d=list(sim.idx_d))
        for d in range(D):
            if D > 1:
                # the ghost columns hold the neighbours' particles: clear x
                # (it gates liveness) and idx (the recovery's presence test)
                sim.xd[d] = _clear_ghost_cols(sim.xd[d], nxl, FAR, donate)
                sim.idx_d[d] = _clear_ghost_cols(sim.idx_d[d], nxl, -1,
                                                 donate)
            before = _count_live(sim.xd[d])
            spill = (sim.sx[d], sim.sy[d], sim.svx[d], sim.svy[d],
                     sim.sidx[d])
            if lean:
                planes, cnt, spill = consume_planar(sim, d, before, spill)
                pre = None
            else:
                pre = (sim.xd[d], sim.yd[d], sim.vxd[d], sim.vyd[d],
                       sim.idx_d[d])
                *planes, cnt = reslot(*pre, d)
            slabs.append([pre, planes, cnt, spill])
            stats.append([before])
        if D > 1:
            # the captures in the ghost columns: lane 0 = left exits, lane
            # nxl+1 = right exits; idx travels as float32 bits
            ex_l = [torch.stack([p[:, :, 0] for p in pl[:4]]
                                + [pl[4][:, :, 0].view(torch.float32)])
                    for _, pl, _, _ in slabs]
            ex_r = [torch.stack([p[:, :, nxl + 1] for p in pl[:4]]
                                + [pl[4][:, :, nxl + 1].view(torch.float32)])
                    for _, pl, _, _ in slabs]
            from_right = mesh.shift_bwd(ex_l, dead_col[-1])
            from_left = mesh.shift_fwd(ex_r, dead_col[0])
        for d, (pre, planes, cnt, _) in enumerate(slabs):
            drop_now = torch.zeros((), dtype=torch.int64, device=cnt.device)
            merge = []
            if D > 1:
                # the edge slabs fold their own outward captures back in
                src1 = ex_l[0] if d == 0 else from_left[d]
                srcn = ex_r[-1] if d == D - 1 else from_right[d]
                for lane, src in ((1, src1), (nxl, srcn)):
                    src = (*src[:4], src[4].contiguous().view(torch.int32))
                    dm = merge_col(planes, lane, src, cnt[:, lane], cap)
                    merge.append((dm, src))
                    drop_now = drop_now + dm.sum()
                exports.append((ex_l[d][4].view(torch.int32),
                                ex_r[d][4].view(torch.int32)))
                planes[4][:, :, 0] = -1
                planes[4][:, :, nxl + 1] = -1
            else:
                exports.append(None)
            merges.append(merge)
            stats[d] += [cnt.sum(), torch.clamp_max(cnt, cap).sum(), drop_now,
                         (sim.sidx[d] >= 0).any()]
        counts = host(stats)
        overflow, lost, dropped = (list(sim.overflow), list(sim.lost),
                                   list(sim.dropped))
        readmitted = list(sim.readmitted)
        out = {k: [] for k in ("xd", "yd", "vxd", "vyd", "idx_d", "sx", "sy",
                               "svx", "svy", "sidx")}
        for d, ((pre, planes, cnt, spill), (before, matched, captured,
                                            drop_now, spilled)) in enumerate(
                zip(slabs, counts)):
            overflow[d] += matched - captured
            lost[d] += before - matched
            dropped[d] += drop_now
            if n is not None and (before - captured > 0 or drop_now > 0
                                  or spilled):
                if pre is not None:
                    # COLLECT the reslot's losses: live pre-rebin slots
                    # found neither in the 3x3 window of their slot in the
                    # new idx plane nor in an export column (the lean path
                    # read them off the code before its applies)
                    found = _found_in_window(pre[4], planes[4])
                    if exports[d] is not None:
                        found |= _found_in_exports(pre[4], *exports[d])
                    spill = _spill_collect((pre[4] >= 0) & ~found, pre,
                                           spill)
                spill, readmitted[d] = _sh_recover(
                    planes, merges[d], spill, readmitted[d], g,
                    origins[d][0], vmax2)
            for name, v in zip(("xd", "yd", "vxd", "vyd", "idx_d"), planes):
                out[name].append(v)
            for name, v in zip(("sx", "sy", "svx", "svy", "sidx"), spill):
                out[name].append(v)
        alive = [v[0] for v in host([[_count_live(_real_cols(xd, nxl))]
                                     for xd in out["xd"]])]
        ref_x, ref_y = refs(out["xd"], out["yd"])
        return dataclasses.replace(
            sim, **out, ref_xd=ref_x, ref_yd=ref_y, occ=occ_of(out["xd"]),
            disp2=[torch.zeros_like(d2) for d2 in sim.disp2],
            alive=alive, overflow=overflow, lost=lost, dropped=dropped,
            readmitted=readmitted, age=0, rebin_count=sim.rebin_count + 1)

    return ShardedSteps(init, pure_step, rebin, need)


# The copying posture (``donate=False``): the halo makes fresh x, y, vx and
# vy planes of every slab while the session still holds the old ones, so
# a slab needs up to this many slab planes beyond the single card's
# ``verlet_solver.FOOTPRINTS`` (the slabs of a card copy together, then
# each K2 replaces its slab's copies: 4 planes a card, at most 4 a slab;
# chip_smoke.py phase 17 measures both postures' peaks).
HALO_COPY_FOOTPRINTS = 4.0


def slab_default(choose, grid, mesh: SlabMesh, donate: bool = False) -> bool:
    """``choose`` (the single card's ``verlet_solver.planar_rebin_default``,
    ``refless_trigger_default`` or ``segmented_run_default``) for a slab
    of ``grid`` that shares its card (slab 0's) with the mesh's other slabs
    there: each gets an equal part of the card's memory, less, unless the
    step owns its planes (``donate``), ``HALO_COPY_FOOTPRINTS`` slab planes
    for the copying halo.  False off the GPU, where no posture is
    automatic."""
    dev = mesh.devices[0]
    if dev.type != "cuda":
        return False
    share = sum(1 for d in mesh.devices if d == dev)
    total = torch.cuda.mem_get_info(dev)[1] // share
    if not donate:
        total -= int(HALO_COPY_FOOTPRINTS * 4 * grid.ny_pad * grid.cap
                     * grid.nx_pad)
    return choose(grid, total)


def extract_state(sim: ShardedDenseSim, spec: sh.ShardSpec,
                  params: FluidParams) -> sh.ShardedState:
    """Per-particle view (off the hot path): each slab's live real slots,
    then its suspended spill entries (at their frozen state, self-density),
    compacted into [capacity] buffers with their original index in
    ``idx``."""
    g = spec.local_grid
    M = spec.capacity
    self_rho = float(self_density(params))
    out = {k: [] for k in ("x", "y", "vx", "vy", "rho", "p", "idx",
                           "alive")}

    def real(a):
        return a[g.row0:g.row0 + g.ny, :, 1:1 + g.nx].reshape(-1)

    for d in range(sim.n_slabs):
        x = torch.cat([real(sim.xd[d]), sim.sx[d]])
        R = x.shape[0]
        slot = _first_k(x < FAR * 0.5, M)
        ok = slot < R
        safe = torch.clamp_max(slot, R - 1)

        def take(a, s, fill):
            return torch.where(ok, torch.cat([real(a), s])[safe], fill)
        srho = torch.full_like(sim.sx[d], self_rho)
        rho = take(sim.rho_d[d], srho, 0.0)
        out["x"].append(take(sim.xd[d], sim.sx[d], FAR))
        out["y"].append(take(sim.yd[d], sim.sy[d], FAR))
        out["vx"].append(take(sim.vxd[d], sim.svx[d], 0.0))
        out["vy"].append(take(sim.vyd[d], sim.svy[d], 0.0))
        out["rho"].append(rho)
        out["p"].append(torch.where(ok, eos_pressure(rho, params), 0.0))
        out["idx"].append(take(sim.idx_d[d], sim.sidx[d], -1))
        out["alive"].append(ok)
    return sh.ShardedState(step=sim.step, **out)


def extract_fluid_state(sim: ShardedDenseSim, spec: sh.ShardSpec,
                        params: FluidParams, n: int) -> FluidState:
    """ORIGINAL-order FluidState from the slabs' dense state (off the hot
    path), on slab 0's device: one scatter keyed by the idx planes, then
    the spill entries at their frozen state; particles lost beyond the
    spill come back at FAR with zero velocity and the self-density."""
    g = spec.local_grid
    dev = sim.xd[0].device

    def real(a):
        return a[g.row0:g.row0 + g.ny, :, 1:1 + g.nx].reshape(-1).to(dev)

    self_rho = float(self_density(params))
    idx = torch.cat([real(a) for a in sim.idx_d])
    vals = torch.stack([torch.cat([real(a) for a in getattr(sim, k)])
                        for k in ("xd", "yd", "vxd", "vyd", "rho_d")],
                       dim=-1)
    out = torch.tensor([FAR, FAR, 0.0, 0.0, self_rho], dtype=torch.float32,
                       device=dev).expand(n, 5).clone()
    live = idx >= 0
    out[idx[live].long()] = vals[live]
    sidx = torch.cat([s.to(dev) for s in sim.sidx])
    svals = torch.stack([torch.cat([s.to(dev) for s in getattr(sim, k)])
                         for k in ("sx", "sy", "svx", "svy")]
                        + [torch.full(sidx.shape, self_rho,
                                      dtype=torch.float32, device=dev)],
                        dim=-1)
    spilled = sidx >= 0
    out[sidx[spilled].long()] = svals[spilled]
    rho = out[:, 4].contiguous()
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return FluidState(x=out[:, 0].contiguous(), y=out[:, 1].contiguous(),
                      vx=out[:, 2].contiguous(), vy=out[:, 3].contiguous(),
                      ax=z, ay=z.clone(), rho=rho,
                      p=eos_pressure(rho, params), step=sim.step)
