"""Deferred-rebinning solver: Verlet skin over the dense cell grid (port of
``bevy_gpu_fluid_tpu/models/verlet_solver.py``, default posture).

Particles are binned once into cells of ``cell_size = skin_factor * h``;
the slot assignment is then FROZEN and the state stays dense between
rebins.  A step is two kernels: density (K1) and the fused
forces + Euler + bounce + skin-trigger pass (K2), both reading neighbours
from the frozen 3x3 slot window.  A rebin fires when some particle has
moved more than half the skin ``(cell_size - h) / 2`` since the last one
(or the bins are ``max_age`` steps old): it is the sort-free local reslot
(K3), so no step ever sorts, scatters or gathers.

Degradation and RECOVERY: particles beyond a cell's ``cap`` at a bin or
rebin lose their slot and are counted (cumulatively) in ``overflow``; they
park in a fixed-size SPILL buffer (frozen, no forces) and re-admit at a
later rebin once their cell has room and they satisfy the skin invariant
|v| dt <= skin_half.  ``lost`` counts particles missed by the +-1 reslot
window, impossible while the skin invariant holds.

The port covers the fused, ref-based, non-planar posture of the reference
(no mono kernel: K1+K2 run at every grid size).  The step loop is a Python
loop, where the reference runs one ``lax.scan`` with a ``lax.cond`` rebin:
the rebin decision reads ``disp2`` on the host, one device sync per step
(the step counters ``age``, ``step`` and ``rebin_count`` are host ints, so
``disp2`` is the only value read back).  Whether a CUDA graph over several
steps, or a check every few steps, pays for itself is a later decision,
to be taken on a measurement.  A rebin also syncs once to read its
counters and decide whether the recovery pass runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..core.state import FluidState
from ..ops import reslot as reslot_ops
from ..ops.binning import FAR, bin_particles, cell_index, inv_cell, to_dense
from ..ops.kernels import eos_pressure, self_density
from . import cuda_solver

SPILL_CAP = 256  # default spill-buffer entries (recovery pool size)

# Grids at least this wide get 4-row blocks: the reference package's row
# block choice (its pick_row_block, a TPU VMEM budget), kept so the dense
# layout stays identical to the reference's at every size.
_WIDE_NX_PAD = 6144


@dataclasses.dataclass
class DenseSim:
    """Dense-resident simulation state between rebins.

    xd/yd/vxd/vyd: float32[ny_pad, cap, nx_pad] current fields (FAR = empty)
    rho_d:         density at the last step's pre-integrate positions
    ref_xd/ref_yd: positions at the last rebin (for the skin trigger)
    idx_d:         int32[ny_pad, cap, nx_pad] original particle index per
                   slot (-1 = empty)
    occ:           int32[3, n_row_blocks] block_kmax3 slot-loop bounds,
                   recomputed at each rebin
    disp2:         float32 0-dim tensor: max squared displacement from the
                   rebin reference, written by the previous step's K2
    sx/sy/svx/svy: float32[spill_cap] spill buffer (FAR/0 = empty entry)
    sidx:          int32[spill_cap] particle index per spill entry (-1 =
                   empty)
    age, overflow, lost, rebin_count, step, readmitted: host ints (steps
                   since the last rebin; cumulative capacity drops,
                   window losses, rebins, steps and re-admissions)
    """

    xd: torch.Tensor
    yd: torch.Tensor
    vxd: torch.Tensor
    vyd: torch.Tensor
    rho_d: torch.Tensor
    ref_xd: torch.Tensor
    ref_yd: torch.Tensor
    idx_d: torch.Tensor
    occ: torch.Tensor
    disp2: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    svx: torch.Tensor
    svy: torch.Tensor
    sidx: torch.Tensor
    age: int = 0
    overflow: int = 0
    lost: int = 0
    rebin_count: int = 1
    step: int = 0
    readmitted: int = 0

    @property
    def suspended(self) -> int:
        """Particles currently parked in the spill buffer."""
        return int((self.sidx >= 0).sum())


def _first_k(mask: torch.Tensor, k: int) -> torch.Tensor:
    """First ``k`` set positions of a flat bool tensor, ascending, padded
    with ``mask.numel()`` (the reference's fixed-size ``nonzero``)."""
    pos = torch.nonzero(mask.reshape(-1)).reshape(-1)[:k]
    pad = pos.new_full((k - pos.numel(),), mask.numel())
    return torch.cat([pos, pad])


def init_dense(state: FluidState, grid: GridSpec2D,
               spill_cap: int = SPILL_CAP,
               collect_spill: bool = True) -> DenseSim:
    """Bin a particle state into the dense representation (sort-based; runs
    once per session).  Particles the sort drops to cell capacity go to the
    spill buffer unless ``collect_spill`` is False (recovery off)."""
    n = state.n
    b = bin_particles(state.x, state.y, grid)
    xd = to_dense(b, state.x, FAR)
    yd = to_dense(b, state.y, FAR)
    idx = torch.arange(n, dtype=torch.int32, device=state.device)
    over = b.rank >= grid.cap if collect_spill \
        else torch.zeros_like(b.rank, dtype=torch.bool)
    dpos = _first_k(over, spill_cap)
    dv = dpos < n
    ds = torch.clamp_max(dpos, n - 1)
    return DenseSim(xd=xd, yd=yd, vxd=to_dense(b, state.vx, 0.0),
                    vyd=to_dense(b, state.vy, 0.0),
                    rho_d=torch.zeros_like(xd), ref_xd=xd, ref_yd=yd,
                    idx_d=to_dense(b, idx, -1),
                    occ=reslot_ops.block_kmax3(xd, grid),
                    disp2=torch.zeros((), dtype=torch.float32,
                                      device=state.device),
                    sx=torch.where(dv, state.x[ds], FAR),
                    sy=torch.where(dv, state.y[ds], FAR),
                    svx=torch.where(dv, state.vx[ds], 0.0),
                    svy=torch.where(dv, state.vy[ds], 0.0),
                    sidx=torch.where(dv, dpos, -1).to(torch.int32),
                    overflow=b.overflow, step=state.step)


def extract_fields(sim: DenseSim, grid: GridSpec2D, params: FluidParams,
                   n: int):
    """Per-particle (x, y, vx, vy, rho) in ORIGINAL order.  Suspended
    particles surface at their frozen state with the self-density; drops
    beyond the spill capacity come back as FAR."""
    def real(a):
        return a[grid.row0:grid.row0 + grid.ny, :, 1:1 + grid.nx].reshape(-1)

    self_rho = float(self_density(params))
    idx = real(sim.idx_d)
    vals = torch.stack([real(sim.xd), real(sim.yd), real(sim.vxd),
                        real(sim.vyd), real(sim.rho_d)], dim=-1)
    out = torch.tensor([FAR, FAR, 0.0, 0.0, self_rho], dtype=torch.float32,
                       device=sim.xd.device).expand(n, 5).clone()
    live = idx >= 0
    out[idx[live].long()] = vals[live]
    spilled = sim.sidx >= 0
    svals = torch.stack([sim.sx, sim.sy, sim.svx, sim.svy,
                         torch.full_like(sim.sx, self_rho)], dim=-1)
    out[sim.sidx[spilled].long()] = svals[spilled]
    return tuple(out[:, i].contiguous() for i in range(5))


def _skin(params: FluidParams, grid: GridSpec2D) -> np.float32:
    """Half the Verlet skin, (cell_size - h) / 2, in float32."""
    return (np.float32(grid.cell_size) - params.h) * np.float32(0.5)


def _spill_recover(ops, *, grid: GridSpec2D, vmax2: np.float32):
    """Overflow recovery at a rebin: COLLECT every particle the reslot just
    dropped (present in the pre-rebin idx planes, absent from the 3x3 cell
    window of its pre-rebin slot in the post planes) into the spill buffer,
    then RE-ADMIT spill entries into cells with free capacity."""
    (xd, yd, vxd, vyd, idx_d, cnt,
     pxd, pyd, pvxd, pvyd, pidx_d,
     sx, sy, svx, svy, sidx, readmitted) = ops
    R, _, C = pidx_d.shape
    padded = F.pad(idx_d, (1, 1, 0, 0, 1, 1), value=-1)
    found = torch.zeros(pidx_d.shape, dtype=torch.bool, device=xd.device)
    for s in range(9):
        win = padded[s // 3:s // 3 + R, :, s % 3:s % 3 + C]
        found |= (pidx_d[:, :, None, :] == win[:, None, :, :]).any(dim=2)
    pre = pidx_d.reshape(-1)
    total = pre.numel()
    dpos = _first_k((pre >= 0) & ~found.reshape(-1), sx.shape[0])
    dv = dpos < total
    dsf = torch.clamp_max(dpos, total - 1)
    drops = (torch.where(dv, pxd.reshape(-1)[dsf], FAR),
             torch.where(dv, pyd.reshape(-1)[dsf], FAR),
             torch.where(dv, pvxd.reshape(-1)[dsf], 0.0),
             torch.where(dv, pvyd.reshape(-1)[dsf], 0.0),
             torch.where(dv, pre[dsf], -1))
    sx, sy, svx, svy, sidx = _spill_merge((sx, sy, svx, svy, sidx), drops)
    return _spill_admit(xd, yd, vxd, vyd, idx_d, cnt,
                        sx, sy, svx, svy, sidx, readmitted,
                        grid=grid, vmax2=vmax2)


def _spill_merge(spill, drops):
    """Merge new drops into the spill buffer, old entries first (oldest-
    first admission), compacting valid entries into the K slots; entries
    beyond K are permanently lost (still counted in ``overflow``)."""
    pool = [torch.cat([a, b]) for a, b in zip(spill, drops)]
    empty = (pool[4] < 0).to(torch.int32)
    keep = torch.argsort(empty, stable=True)[:spill[0].shape[0]]
    return tuple(p[keep] for p in pool)


def _spill_admit(xd, yd, vxd, vyd, idx_d, cnt,
                 sx, sy, svx, svy, sidx, readmitted, *,
                 grid: GridSpec2D, vmax2: np.float32):
    """Re-admit spill entries into cells with free post-rebin capacity, at
    ranks continuing from the cell's occupancy, oldest first; only entries
    with |v|^2 <= vmax2 come back.  Writes the admitted entries into the
    given planes IN PLACE (they are the fresh reslot outputs)."""
    cap = grid.cap
    K = sx.shape[0]
    valid = sidx >= 0
    inv = inv_cell(grid)
    gx = torch.where(valid, sx, float(np.float32(grid.origin_x)))
    gy = torch.where(valid, sy, float(np.float32(grid.origin_y)))
    row = cell_index(gy, grid.origin_y, inv, 0, grid.ny - 1) + grid.row0
    col = cell_index(gx, grid.origin_x, inv, 0, grid.nx - 1) + 1
    base = torch.clamp_max(cnt[row, col], cap)
    cid = row * grid.nx_pad + col
    io = torch.arange(K, device=sx.device)
    elig = valid & (svx * svx + svy * svy <= float(vmax2))
    rank = ((cid[:, None] == cid[None, :]) & elig[None, :]
            & (io[None, :] < io[:, None])).sum(dim=1)
    admit = elig & (base + rank < cap)
    r, s, c = row[admit], (base + rank)[admit], col[admit]
    for plane, vals in ((xd, sx), (yd, sy), (vxd, svx), (vyd, svy),
                        (idx_d, sidx)):
        plane[r, s, c] = vals[admit]
    readmitted = readmitted + int(admit.sum())
    sx = torch.where(admit, FAR, sx)
    sy = torch.where(admit, FAR, sy)
    svx = torch.where(admit, 0.0, svx)
    svy = torch.where(admit, 0.0, svy)
    sidx = torch.where(admit, -1, sidx)
    return xd, yd, vxd, vyd, idx_d, sx, sy, svx, svy, sidx, readmitted


def make_step_parts(params: FluidParams, cfg: IntegrateConfig,
                    grid: GridSpec2D, max_age: int = 64,
                    n: int | None = None):
    """The dense step as ``(pure_step, rebin, need)``: ``need(sim)`` is the
    rebin trigger (a host bool), ``rebin(sim)`` the local reslot with
    recovery, ``pure_step(sim)`` the two kernels.  ``n`` (the particle
    count) arms overflow recovery; with ``n=None`` drops are counted but
    the spill buffer is never refilled or drained.  Requires
    ``grid.cell_size > params.h`` (a real skin)."""
    reslot = reslot_ops.make_reslot(grid)
    skin_half = _skin(params, grid)
    skin2 = float(skin_half * skin_half)
    q = skin_half / cfg.dt
    vmax2 = q * q

    def rebin(sim: DenseSim) -> DenseSim:
        xd, yd, vxd, vyd, idx_d, cnt = reslot(
            sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d)
        alive_before, matched, captured, spilled = torch.stack([
            (sim.xd < FAR * 0.5).sum(), cnt.sum(),
            torch.clamp_max(cnt, grid.cap).sum(),
            (sim.sidx >= 0).any().long()]).tolist()
        sx, sy, svx, svy = sim.sx, sim.sy, sim.svx, sim.svy
        sidx, readmitted = sim.sidx, sim.readmitted
        if n is not None and (alive_before - captured > 0 or spilled):
            (xd, yd, vxd, vyd, idx_d, sx, sy, svx, svy, sidx,
             readmitted) = _spill_recover(
                (xd, yd, vxd, vyd, idx_d, cnt,
                 sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d,
                 sx, sy, svx, svy, sidx, readmitted),
                grid=grid, vmax2=vmax2)
        return DenseSim(xd=xd, yd=yd, vxd=vxd, vyd=vyd, rho_d=sim.rho_d,
                        ref_xd=xd, ref_yd=yd, idx_d=idx_d,
                        occ=reslot_ops.block_kmax3(xd, grid),
                        disp2=torch.zeros_like(sim.disp2),
                        sx=sx, sy=sy, svx=svx, svy=svy, sidx=sidx,
                        age=0, overflow=sim.overflow + matched - captured,
                        lost=sim.lost + alive_before - matched,
                        rebin_count=sim.rebin_count + 1, step=sim.step,
                        readmitted=readmitted)

    def need(sim: DenseSim) -> bool:
        """Rebin before this step's kernels: a particle outran half the
        skin (disp2 from the previous step's K2) or the bins aged out.
        Reads disp2 back to the host."""
        return sim.age >= max_age or float(sim.disp2) > skin2

    def pure_step(sim: DenseSim) -> DenseSim:
        rho_d = cuda_solver.density_cuda(sim.xd, sim.yd, params, grid,
                                         sim.occ)
        xd, yd, vxd, vyd, disp2 = cuda_solver.forces_integrate_cuda(
            sim.xd, sim.yd, sim.vxd, sim.vyd, rho_d, sim.ref_xd, sim.ref_yd,
            params, cfg, grid, sim.occ)
        return dataclasses.replace(sim, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                                   rho_d=rho_d, disp2=disp2,
                                   age=sim.age + 1, step=sim.step + 1)

    return pure_step, rebin, need


def make_step(params: FluidParams, cfg: IntegrateConfig, grid: GridSpec2D,
              max_age: int = 64, n: int | None = None):
    """The dense step fn DenseSim -> DenseSim: rebin if needed, then the
    two kernels (see ``make_step_parts``)."""
    pure_step, rebin, need = make_step_parts(params, cfg, grid, max_age, n)

    def step(sim: DenseSim) -> DenseSim:
        if need(sim):
            sim = rebin(sim)
        return pure_step(sim)

    return step


def default_grid(params_h: float, x_min: float, x_max: float, y_max: float,
                 cap: int = 8, skin_factor: float = 1.5) -> GridSpec2D:
    """Binning grid with a Verlet skin: cells of skin_factor*h over
    [x_min, x_max] x [0, y_max]."""
    g = GridSpec2D.from_bounds(h=params_h * skin_factor, x_min=x_min,
                               x_max=x_max, y_min=0.0, y_max=y_max, cap=cap)
    if g.nx_pad >= _WIDE_NX_PAD:
        g = dataclasses.replace(g, row_block=4)
    return g


def multi_step(state: FluidState, params: FluidParams, cfg: IntegrateConfig,
               grid: GridSpec2D, n_steps: int, max_age: int = 64,
               spill_cap: int = SPILL_CAP):
    """n_steps with deferred rebinning and recovery, from a fresh binning;
    returns (FluidState, dropped, rebins) where ``dropped`` is the
    cumulative capacity overflow plus reslot losses."""
    stepf = make_step(params, cfg, grid, max_age, n=state.n)
    sim = init_dense(state, grid, spill_cap)
    for _ in range(n_steps):
        sim = stepf(sim)
    x, y, vx, vy, rho = extract_fields(sim, grid, params, state.n)
    out = state.replace(x=x, y=y, vx=vx, vy=vy, rho=rho,
                        p=eos_pressure(rho, params), step=sim.step)
    return out, sim.overflow + sim.lost, sim.rebin_count


class Session:
    """Persistent dense-resident run: ``run(k)`` advances k steps on the
    device with no per-call rebinning, and ``state()`` materializes a
    FluidState only when asked.  ``device`` is where the dense state lives
    (the input state is copied there)."""

    def __init__(self, state: FluidState, params: FluidParams,
                 cfg: IntegrateConfig, grid: GridSpec2D, *, device,
                 max_age: int = 64, spill_cap: int = SPILL_CAP,
                 recovery: bool = True):
        """``recovery=False`` reverts overflow handling to the counted-loss
        contract: drops are counted, never collected or re-admitted."""
        self.params = params
        self.cfg = cfg
        self.grid = grid
        self.n = state.n
        self.device = torch.device(device)
        self._pure_step, self._rebin, self._need = make_step_parts(
            params, cfg, grid, max_age, n=self.n if recovery else None)
        self.sim = init_dense(state.to(self.device), grid, spill_cap,
                              collect_spill=recovery)

    def run(self, n_steps: int) -> None:
        """Advance n_steps: per step, rebin if the trigger fired, then the
        two kernels.  Returns as soon as the last step is enqueued (apart
        from the per-step trigger read)."""
        for _ in range(n_steps):
            if self._need(self.sim):
                self.sim = self._rebin(self.sim)
            self.sim = self._pure_step(self.sim)

    def state(self) -> FluidState:
        """Materialize the per-particle FluidState (on demand only)."""
        x, y, vx, vy, rho = extract_fields(self.sim, self.grid, self.params,
                                           self.n)
        z = torch.zeros_like(x)
        return FluidState(x=x, y=y, vx=vx, vy=vy, ax=z, ay=z.clone(),
                          rho=rho, p=eos_pressure(rho, self.params),
                          step=self.sim.step)

    @property
    def overflow(self) -> int:
        """Cumulative capacity drops (recoverable ones included) plus
        window losses."""
        return self.sim.overflow + self.sim.lost

    @property
    def suspended(self) -> int:
        """Particles currently parked in the spill buffer."""
        return self.sim.suspended

    @property
    def readmitted(self) -> int:
        """Cumulative overflow recoveries (spill re-admissions)."""
        return self.sim.readmitted
