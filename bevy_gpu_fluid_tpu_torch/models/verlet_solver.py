"""Deferred-rebinning solver: Verlet skin over the dense cell grid (port of
``bevy_gpu_fluid_tpu/models/verlet_solver.py``, default posture).

Particles are binned once into cells of ``cell_size = skin_factor * h``;
the slot assignment is then FROZEN and the state stays dense between
rebins.  A step is two kernels, density (K1) and the fused
forces + Euler + bounce + skin-trigger pass (K2), both reading neighbours
from the frozen 3x3 slot window; on grids under ``MONO_MAX_BLOCKS`` row
blocks it is the one mono kernel (K5) that does both, as in the
reference.  A rebin fires when some particle has
moved more than half the skin ``(cell_size - h) / 2`` since the last one
(or the bins are ``max_age`` steps old): it is the sort-free local reslot
(K3), so no step ever sorts, scatters or gathers.

Degradation and RECOVERY: particles beyond a cell's ``cap`` at a bin or
rebin lose their slot and are counted (cumulatively) in ``overflow``; they
park in a fixed-size SPILL buffer (frozen, no forces) and re-admit at a
later rebin once their cell has room and they satisfy the skin invariant
|v| dt <= skin_half.  ``lost`` counts particles missed by the +-1 reslot
window, impossible while the skin invariant holds.

The port covers the postures of the reference: the fused step (K1 + K2,
or K5 on small grids) by default; the unfused step with explicit
``stencils`` (density, then forces, e.g. K1 + K8 from
``cuda_solver.make_stencils``, then Euler, bounce and the trigger as torch
ops); the PLANAR rebin (``planar=True`` / ``planar_rebin=True``), which
splits K3 into one routing pass (K6) and five plane copies (K7) to lower
the rebin's peak memory, with bitwise the same result; and the postures of
the card's memory ceiling: the REFLESS trigger (no reference planes: K2's
refless epilogue reports each step's largest move and ``disp2`` sums their
square roots, a conservative bound, so rebins fire somewhat earlier and the
trajectory is not bitwise the ref-based one), owned planes
(``donate=True``: K1 writes the new rho into the dead rho plane), the
chunked and generator inits (``init_dense_chunked``, ``init_dense_gen``:
O(N/K) transients, no [N] particle planes; bitwise ``init_dense``) and the
segmented driver (``step_until`` + a separate rebin; bitwise the standard
run).  ``Session`` picks the planar rebin, the refless trigger and the
segmented driver from the card's memory (``planar_rebin_default``,
``refless_trigger_default``, ``segmented_run_default``: plane-footprints
measured on an H100).  The step
loop is a Python loop, where the reference runs one ``lax.scan`` with a
``lax.cond`` rebin:
the rebin decision reads ``disp2`` on the host, one device sync per step
(the step counters ``age``, ``step`` and ``rebin_count`` are host ints, so
``disp2`` is the only value read back).  Whether a CUDA graph over several
steps, or a check every few steps, pays for itself is a later decision,
to be taken on a measurement.  A rebin also syncs once to read its
counters and decide whether the recovery pass runs.

Frames (``Session.run_frame``/``run_frames``/``frame``) render the
density field straight from the resident planes (render/raster.py, kernel
K4); ``Session.kick`` applies the drag impulse to them in place of a
per-particle state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..core.state import FluidState
from ..interact.impulse import IMPULSE, apply_impulse_arrays
from ..ops import reslot as reslot_ops
from ..ops.binning import (FAR, bin_particles, cell_coords, cell_index,
                           inv_cell, stable_rank, to_dense)
from ..ops.kernels import eos_pressure, self_density
from ..render import raster
from . import cuda_solver

SPILL_CAP = 256  # default spill-buffer entries (recovery pool size)

# Grids at least this wide get 4-row blocks: the reference package's row
# block choice (its pick_row_block, a TPU VMEM budget), kept so the dense
# layout stays identical to the reference's at every size.
_WIDE_NX_PAD = 6144

# Peak device memory of each posture in PLANE-FOOTPRINTS (torch's peak
# allocated bytes over one dense plane's bytes), the larger of one step and
# one step that rebins with recovery armed, measured by chip_smoke.py phase
# 14 on a 16M-particle scene on an NVIDIA H100 80GB HBM3 (700 W power
# limit).  The automatic postures below compare them, times a plane's
# bytes, with the card's memory.
FOOTPRINTS = {
    "default": 15.375,           # fused K1 + K2 + K3, ref-based trigger:
                                 # the fused rebin binds (the step 13)
    "planar": 13.0,              # + the planar rebin: the step binds
    "ceiling": 10.0,             # refless + planar + owned planes
                                 # (donate: K1 into the dead rho)
    "ceiling_segmented": 10.0,   # + the segmented driver: no change
}
# Bytes of the card kept out of the estimate: the CUDA context, the
# allocator's rounding and the small tensors of the step.
RESERVE_BYTES = 2 << 30


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


def _ref_placeholder(device) -> torch.Tensor:
    """Stand-in for the rebin-reference planes in the refless posture: a
    (1, 1, 1) float32 tensor, so the two plane-footprints are freed (the
    refless step never reads them)."""
    return torch.zeros((1, 1, 1), dtype=torch.float32, device=device)


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


def _chunk_init_carry(grid: GridSpec2D, spill_cap: int, device) -> dict:
    """The chunked init's state before the first chunk: empty planes, zero
    running cell counts, no overflow, an empty spill buffer."""
    shape = grid.plane_shape
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        xd=torch.full(shape, FAR, **f32), yd=torch.full(shape, FAR, **f32),
        vxd=torch.zeros(shape, **f32), vyd=torch.zeros(shape, **f32),
        idx_d=torch.full(shape, -1, dtype=torch.int32, device=device),
        cnt=torch.zeros((grid.ny, grid.nx), dtype=torch.int32,
                        device=device),
        overflow=0,
        spill=(torch.full((spill_cap,), FAR, **f32),
               torch.full((spill_cap,), FAR, **f32),
               torch.zeros(spill_cap, **f32), torch.zeros(spill_cap, **f32),
               torch.full((spill_cap,), -1, dtype=torch.int32,
                          device=device)))


def _chunk_init_body(carry: dict, chunk, grid: GridSpec2D,
                     collect_spill: bool) -> None:
    """Bin one chunk (x, y, vx, vy, idx; idx int32, original order) into
    the carry IN PLACE.  A particle's slot is its stable rank within the
    chunk plus its cell's count from the earlier chunks: the global stable
    rank of the sort-based init, since chunks come in original order.
    Entries with idx -1 are dead (a slab's empty buffer slots, another
    slab's particles): they rank in the void cell and are never stored.
    ``grid`` carries the world origin (a slab's: ``shard.slab_grid``)."""
    x, y, vx, vy, idx = chunk
    valid = idx >= 0
    cx, cy = cell_coords(x, y, grid)
    slot = carry["cnt"][cy, cx].to(torch.int64) + stable_rank(
        torch.where(valid, cx + cy * grid.nx, grid.num_cells))
    over = valid & (slot >= grid.cap)
    keep = valid & ~over
    row, col, slot = cy[keep] + grid.row0, cx[keep] + 1, slot[keep]
    for name, v in (("xd", x), ("yd", y), ("vxd", vx), ("vyd", vy),
                    ("idx_d", idx)):
        carry[name][row, slot, col] = v[keep]
    carry["cnt"].index_put_((cy[valid], cx[valid]),
                            torch.ones_like(cy[valid], dtype=torch.int32),
                            accumulate=True)
    carry["overflow"] += int(over.sum())
    if collect_spill:
        m = x.shape[0]
        dpos = _first_k(over, carry["spill"][0].shape[0])
        dv = dpos < m
        ds = torch.clamp_max(dpos, m - 1)
        carry["spill"] = _spill_merge(carry["spill"], tuple(
            torch.where(dv, v[ds], fill)
            for v, fill in zip((x, y, vx, vy, idx), _FILLS)))


def _chunk_init_finish(carry: dict, grid: GridSpec2D, step: int) -> DenseSim:
    xd, yd = carry["xd"], carry["yd"]
    sx, sy, svx, svy, sidx = carry["spill"]
    return DenseSim(xd=xd, yd=yd, vxd=carry["vxd"], vyd=carry["vyd"],
                    rho_d=torch.zeros_like(xd), ref_xd=xd, ref_yd=yd,
                    idx_d=carry["idx_d"],
                    occ=reslot_ops.block_kmax3(xd, grid),
                    disp2=torch.zeros((), dtype=torch.float32,
                                      device=xd.device),
                    sx=sx, sy=sy, svx=svx, svy=svy, sidx=sidx,
                    overflow=carry["overflow"], step=step)


def init_dense_chunked(state: FluidState, grid: GridSpec2D, n_chunks: int,
                       spill_cap: int = SPILL_CAP,
                       collect_spill: bool = True) -> DenseSim:
    """``init_dense`` with O(N / n_chunks) transient memory: a Python loop
    over ``n_chunks`` slices of the particles in original order, each
    binned with its own stable sort into the planes and a running
    per-cell count.  Bitwise ``init_dense``'s DenseSim (every plane, the
    spill buffer, overflow and occ): the slots are the sort's global
    stable ranks, the spill keeps the first drops in particle order."""
    n = state.n
    c = -(-n // n_chunks)
    carry = _chunk_init_carry(grid, spill_cap, state.device)
    for lo in range(0, n, c):
        hi = min(lo + c, n)
        idx = torch.arange(lo, hi, dtype=torch.int32, device=state.device)
        _chunk_init_body(carry, (state.x[lo:hi], state.y[lo:hi],
                                 state.vx[lo:hi], state.vy[lo:hi], idx),
                         grid, collect_spill)
    return _chunk_init_finish(carry, grid, state.step)


def init_dense_gen(gen, n: int, grid: GridSpec2D, n_chunks: int,
                   spill_cap: int = SPILL_CAP, collect_spill: bool = True,
                   step: int = 0, device="cuda") -> DenseSim:
    """``init_dense_chunked`` with the chunks COMPUTED instead of sliced:
    ``gen(gi)`` maps an int64 tensor of global particle indices to that
    chunk's (x, y, vx, vy) float32 tensors on ``device`` (e.g.
    ``core.state.lattice_gen``).  No [N] tensor is ever made: the
    particles' four planes, and the sort workspace, exist one chunk at a
    time.  Bitwise ``init_dense`` on the state ``gen`` describes."""
    device = torch.device(device)
    c = -(-n // n_chunks)
    carry = _chunk_init_carry(grid, spill_cap, device)
    for lo in range(0, n, c):
        gi = torch.arange(lo, min(lo + c, n), device=device)
        x, y, vx, vy = gen(gi)
        _chunk_init_body(carry, (x, y, vx, vy, gi.to(torch.int32)), grid,
                         collect_spill)
        del x, y, vx, vy, gi
    return _chunk_init_finish(carry, grid, step)


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


_FILLS = reslot_ops.PLANE_FILLS   # empty x, y, vx, vy, idx slots


def _found_in_window(pidx_d: torch.Tensor, idx_d: torch.Tensor):
    """Per pre-rebin slot: is its particle index present in the 3x3 cell
    window of its slot in the post-rebin idx plane?  (The fused rebin's
    drop test: a live pre-rebin slot not found was dropped.)"""
    R, _, C = pidx_d.shape
    padded = F.pad(idx_d, (1, 1, 0, 0, 1, 1), value=-1)
    found = torch.zeros(pidx_d.shape, dtype=torch.bool, device=idx_d.device)
    for s in range(9):
        win = padded[s // 3:s // 3 + R, :, s % 3:s % 3 + C]
        found |= (pidx_d[:, :, None, :] == win[:, None, :, :]).any(dim=2)
    return found


def _spill_collect(dropped: torch.Tensor, planes, spill):
    """Overflow recovery's COLLECT: the first spill-capacity slots flagged
    in ``dropped`` (flat C order), read from the pre-rebin planes (x, y,
    vx, vy, idx), merged into the spill buffer (x, y, vx, vy, idx)."""
    total = dropped.numel()
    dpos = _first_k(dropped, spill[0].shape[0])
    dv = dpos < total
    dsf = torch.clamp_max(dpos, total - 1)
    return _spill_merge(spill, tuple(
        torch.where(dv, p.reshape(-1)[dsf], fill)
        for p, fill in zip(planes, _FILLS)))


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
                    n: int | None = None, *, stencils=None,
                    planar: bool = False, code_dtype=torch.int32,
                    refless: bool = False, donate: bool = False,
                    kernels=None):
    """The dense step as ``(pure_step, rebin, need)``: ``need(sim)`` is the
    rebin trigger (a host bool), ``rebin(sim)`` the local reslot with
    recovery, ``pure_step(sim)`` the step's kernels.  ``n`` (the particle
    count) arms overflow recovery; with ``n=None`` drops are counted but
    the spill buffer is never refilled or drained.  Requires
    ``grid.cell_size > params.h`` (a real skin).

    ``stencils=None`` (the default) steps on the fused kernels: K5 on grids
    under ``MONO_MAX_BLOCKS`` row blocks, else K1 + K2.  An explicit
    ``(density_fn, forces_fn)`` pair (``cuda_solver.make_stencils(grid)``
    for K1 + K8, or ``grid_solver.XLA_STENCILS``) takes the unfused step:
    density, forces, then Euler, bounce and the displacement trigger as
    torch ops on the planes.

    ``planar=True`` rebins plane at a time: K6 writes a routing code plane
    (int32, or int8 with ``code_dtype=torch.int8``), the drops are read off
    it (``taken_mask``), then K7 routes the five payload planes one by one.
    Same slot assignment, counters and recovery as the fused rebin, bit for
    bit.  The rebin TAKES the planes of the DenseSim it is given (its x,
    y, vx, vy, idx and reference fields are left None) and frees each
    input plane once its copy is made, so its peak holds about one payload
    plane and the code beyond the resident set, where the fused rebin
    holds five new planes beside the old ones.  If the rebin fails before
    any input plane was consumed, the DenseSim gets its planes back (its
    references set to them: the rebin is still due); after that it cannot
    be restored, and the error says so.

    ``refless=True`` is the REFLESS trigger: the DenseSim carries (1, 1, 1)
    placeholders for the reference planes (two plane-footprints fewer),
    K2 (or the unfused tail) reports the step's largest squared move and
    ``disp2`` accumulates its square root, compared with half the skin
    unsquared.  A conservative bound: rebins fire somewhat earlier, the
    physics is the same, but the trajectory is not bitwise the ref-based
    one.  It never steps on K5.

    ``donate=True``: the step OWNS the planes of the DenseSim it is given.
    K1 writes the new rho into the old rho plane (``density_cuda``'s
    ``out``; the stencils' ``out`` where their ``takes_out`` says so), so
    the given DenseSim's ``rho_d`` changes under it.

    ``kernels`` stands in for the kernel wrappers: any namespace with
    ``density_cuda``, ``forces_integrate_cuda``, ``mono_step_cuda`` and
    ``reslot_cuda`` of the wrappers' signatures (``kernels.ops``: the same
    kernels as ``torch.library`` operators, which ``torch.export`` traces;
    ``utils/aot.py``).  The default calls the wrappers directly."""
    reslot_ops.check_code_dtype(code_dtype, grid.cap)
    ks = cuda_solver if kernels is None else kernels
    reslot = (reslot_ops.make_reslot(grid) if kernels is None
              else lambda *planes: kernels.reslot_cuda(*planes, grid))
    skin_half = _skin(params, grid)
    skin2 = float(skin_half * skin_half)
    q = skin_half / cfg.dt
    vmax2 = q * q
    fused = stencils is None
    mono = (fused and grid.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS
            and not refless)
    if not fused:
        density_fn, forces_fn = stencils
    rho_into = donate and (fused or getattr(density_fn, "takes_out", False))

    def fresh_refs(xd, yd):
        """The rebin references of new position planes."""
        if refless:
            return _ref_placeholder(xd.device), _ref_placeholder(xd.device)
        return xd, yd

    def host_counts(xd, cnt, sidx):
        """(alive_before, matched, captured) and whether recovery runs (a
        particle lost its slot, or the spill buffer holds one): one sync."""
        alive_before, matched, captured, spilled = torch.stack([
            (xd < FAR * 0.5).sum(), cnt.sum(),
            torch.clamp_max(cnt, grid.cap).sum(),
            (sidx >= 0).any().long()]).tolist()
        return ((alive_before, matched, captured),
                n is not None and (alive_before - captured > 0 or spilled))

    def rebinned(sim: DenseSim, planes, cnt, stats, spill,
                 recover: bool) -> DenseSim:
        """The DenseSim after a rebin: recovery's RE-ADMIT into the new
        planes, fresh references and bounds, the counters advanced."""
        alive_before, matched, captured = stats
        readmitted = sim.readmitted
        if recover:
            out = _spill_admit(*planes, cnt, *spill, readmitted, grid=grid,
                               vmax2=vmax2)
            planes, spill, readmitted = out[:5], out[5:10], out[10]
        xd, yd, vxd, vyd, idx_d = planes
        sx, sy, svx, svy, sidx = spill
        ref_xd, ref_yd = fresh_refs(xd, yd)
        return DenseSim(xd=xd, yd=yd, vxd=vxd, vyd=vyd, rho_d=sim.rho_d,
                        ref_xd=ref_xd, ref_yd=ref_yd, idx_d=idx_d,
                        occ=reslot_ops.block_kmax3(xd, grid),
                        disp2=torch.zeros_like(sim.disp2),
                        sx=sx, sy=sy, svx=svx, svy=svy, sidx=sidx,
                        age=0, overflow=sim.overflow + matched - captured,
                        lost=sim.lost + alive_before - matched,
                        rebin_count=sim.rebin_count + 1, step=sim.step,
                        readmitted=readmitted)

    def rebin(sim: DenseSim) -> DenseSim:
        old = (sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d)
        *planes, cnt = reslot(*old)
        stats, recover = host_counts(sim.xd, cnt, sim.sidx)
        spill = (sim.sx, sim.sy, sim.svx, sim.svy, sim.sidx)
        if recover:
            dropped = (sim.idx_d >= 0) & ~_found_in_window(sim.idx_d,
                                                          planes[4])
            spill = _spill_collect(dropped, old, spill)
        return rebinned(sim, planes, cnt, stats, spill, recover)

    def rebin_planar(sim: DenseSim) -> DenseSim:
        old = [sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d]
        # the rebin owns the planes: with no reference left in ``sim``, the
        # reference planes die now and each old plane once its copy exists
        sim.xd = sim.yd = sim.vxd = sim.vyd = sim.idx_d = None
        sim.ref_xd = sim.ref_yd = None
        try:
            code, cnt = reslot_ops.select_cuda(old[0], old[1], grid, sim.occ,
                                               code_dtype)
            stats, recover = host_counts(old[0], cnt, sim.sidx)
            spill = (sim.sx, sim.sy, sim.svx, sim.svy, sim.sidx)
            if recover:     # collect before the applies free the old planes
                dropped = ((old[4] >= 0)
                           & ~reslot_ops.taken_mask(code, grid.cap))
                spill = _spill_collect(dropped, old, spill)
                del dropped
            planes = reslot_ops.apply_planes(old, code, sim.occ, grid)
        except BaseException as exc:
            if any(p is None for p in old):
                raise RuntimeError(
                    "planar rebin failed after consuming input planes; the "
                    "DenseSim is lost (Session.reset restarts it)") from exc
            # nothing consumed: hand the planes back.  The rebin is still
            # due, so the next step rebins before it reads the references.
            sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d = old
            sim.ref_xd, sim.ref_yd = fresh_refs(old[0], old[1])
            raise
        del code
        return rebinned(sim, planes, cnt, stats, spill, recover)

    def need(sim: DenseSim) -> bool:
        """Rebin before this step's kernels: a particle outran half the
        skin (disp2 from the previous step's K2; refless: the summed step
        maxima, unsquared) or the bins aged out.  Reads disp2 back to the
        host."""
        if sim.age >= max_age:
            return True
        return float(sim.disp2) > (float(skin_half) if refless else skin2)

    def pure_step(sim: DenseSim) -> DenseSim:
        if mono:
            xd, yd, vxd, vyd, rho_d, disp2 = ks.mono_step_cuda(
                sim.xd, sim.yd, sim.vxd, sim.vyd, sim.ref_xd, sim.ref_yd,
                params, cfg, grid, sim.occ)
            return dataclasses.replace(sim, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                                       rho_d=rho_d, disp2=disp2,
                                       age=sim.age + 1, step=sim.step + 1)
        out = sim.rho_d if rho_into else None
        if fused:
            rho_d = ks.density_cuda(sim.xd, sim.yd, params, grid, sim.occ,
                                    out=out)
            xd, yd, vxd, vyd, disp2 = ks.forces_integrate_cuda(
                sim.xd, sim.yd, sim.vxd, sim.vyd, rho_d, sim.ref_xd,
                sim.ref_yd, params, cfg, grid, sim.occ, refless=refless)
        else:
            kw = {} if out is None else {"out": out}
            rho_d = density_fn(sim.xd, sim.yd, params, occ=sim.occ, **kw)
            ax, ay = forces_fn(sim.xd, sim.yd, sim.vxd, sim.vyd, rho_d,
                               params, occ=sim.occ)
            xd, yd, vxd, vyd, disp2 = cuda_solver.integrate_into(
                sim.xd, sim.yd, sim.vxd, sim.vyd, ax, ay, sim.ref_xd,
                sim.ref_yd, cfg, refless=refless)
            del ax, ay
        if refless:
            disp2 = sim.disp2 + torch.sqrt(disp2)
        return dataclasses.replace(sim, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                                   rho_d=rho_d, disp2=disp2,
                                   age=sim.age + 1, step=sim.step + 1)

    return pure_step, (rebin_planar if planar else rebin), need


def make_step(params: FluidParams, cfg: IntegrateConfig, grid: GridSpec2D,
              max_age: int = 64, n: int | None = None, *, stencils=None,
              planar: bool = False, code_dtype=torch.int32,
              refless: bool = False):
    """The dense step fn DenseSim -> DenseSim: rebin if needed, then the
    step's kernels (see ``make_step_parts`` for the options)."""
    pure_step, rebin, need = make_step_parts(
        params, cfg, grid, max_age, n, stencils=stencils, planar=planar,
        code_dtype=code_dtype, refless=refless)

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


def _card_bytes(total_bytes, device):
    """The memory the automatic postures budget against: ``total_bytes``
    when given, else the CUDA device's total (``torch.cuda.mem_get_info``);
    None for a CPU device, where no posture is automatic."""
    if total_bytes is not None:
        return total_bytes
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def _fits(footprints: float, grid: GridSpec2D, total_bytes,
          device="cuda") -> bool:
    """Whether ``footprints`` planes of ``grid`` fit the card's memory
    (less ``RESERVE_BYTES``); True where there is no card to budget."""
    total = _card_bytes(total_bytes, device)
    if total is None:
        return True
    plane_bytes = 4 * grid.ny_pad * grid.cap * grid.nx_pad
    return footprints * plane_bytes + RESERVE_BYTES <= total


def planar_rebin_default(grid: GridSpec2D, total_bytes: int | None = None,
                         device="cuda") -> bool:
    """Auto-select the plane-at-a-time rebin where the default posture,
    whose fused rebin sets its peak (``FOOTPRINTS["default"]``), does not
    fit the card."""
    return not _fits(FOOTPRINTS["default"], grid, total_bytes, device)


def refless_trigger_default(grid: GridSpec2D,
                            total_bytes: int | None = None,
                            device="cuda") -> bool:
    """Auto-select the refless trigger where even the ref-based posture
    with the planar rebin (``FOOTPRINTS["planar"]``: its step binds, eight
    resident planes, K1's rho and K2's four) does not fit the card."""
    return not _fits(FOOTPRINTS["planar"], grid, total_bytes, device)


def segmented_run_default(grid: GridSpec2D, total_bytes: int | None = None,
                          device="cuda") -> bool:
    """Auto-select the segmented driver where it fits and the standard
    driver does not.  Both are host loops here, and the probe measured the
    same peak for both (``FOOTPRINTS["ceiling_segmented"]`` against
    ``["ceiling"]``), so on this card it never engages by itself."""
    return (_fits(FOOTPRINTS["ceiling_segmented"], grid, total_bytes, device)
            and not _fits(FOOTPRINTS["ceiling"], grid, total_bytes, device))


def step_until(sim: DenseSim, k: int, pure_step, need):
    """Pure steps (no rebin) until the trigger fires or ``k`` steps are
    done: returns (sim, steps_done, need), ``need`` the trigger's value
    before the next step.  The segmented driver's step segment."""
    done = 0
    pending = need(sim)
    while done < k and not pending:
        sim = pure_step(sim)
        done += 1
        pending = need(sim)
    return sim, done, pending


def run_segmented(owner, n_steps: int, chunk: int | None, pure_step, need,
                  rebin) -> None:
    """The segmented driver of ``Session`` and ``ShardedSession``
    (``owner``, whose ``sim`` it advances n_steps): ``step_until``
    segments of at most ``chunk`` steps, and a rebin wherever a segment
    stopped on the trigger with steps left.  Bitwise the standard run: a
    rebin runs exactly where a step's check would have run it (a segment
    that ends on its bound with the trigger clear continues in the next).
    ``owner.sim`` is set after every segment and rebin, so a rebin that
    fails leaves the owner at the state it failed on."""
    cap = n_steps if chunk is None else chunk
    done = 0
    while done < n_steps:
        k = min(cap, n_steps - done)
        owner.sim, did, pending = step_until(owner.sim, k, pure_step, need)
        done += did
        if done < n_steps and pending:
            owner.sim = rebin(owner.sim)


def _session_fingerprint(stencils, max_age: int, recovery: bool,
                         refless: bool, code_dtype) -> dict:
    """Solver knobs that a checkpoint records and a restore must match for
    a bitwise continuation, in the reference's kinds (its
    ``_session_fingerprint``): "fused-pallas" for the fused kernels,
    "custom-stencils" otherwise; the reslot is always "default" here.
    ``code_dtype`` is recorded too (an artifact of the reference lacks it,
    and ``check_fingerprint`` compares only the saved keys).  The planar
    rebin and donation are bit-neutral and absent."""
    return {
        "solver": "fused-pallas" if stencils is None else "custom-stencils",
        "reslot": "default",
        "max_age": max_age,
        "recovery": recovery,
        "refless": refless,
        "code_dtype": str(code_dtype).removeprefix("torch."),
    }


class Session:
    """Persistent dense-resident run: ``run(k)`` advances k steps on the
    device with no per-call rebinning, ``run_frame``/``run_frames``/
    ``frame`` render the density field from the resident planes, and
    ``state()`` materializes a FluidState only when asked.  ``device`` is
    where the dense state lives (the input state is copied there); it
    defaults to the GPU.  ``save``/``restore`` checkpoint the resident
    state, and a restored Session continues bitwise."""

    def __init__(self, state: FluidState, params: FluidParams,
                 cfg: IntegrateConfig, grid: GridSpec2D, *, device="cuda",
                 stencils=None, max_age: int = 64,
                 spill_cap: int = SPILL_CAP, recovery: bool = True,
                 planar_rebin: bool | None = None, code_dtype=torch.int32,
                 init_chunks: int | None = None, donate: bool = False,
                 refless_trigger: bool | None = None,
                 segmented: bool | None = None):
        """``recovery=False`` reverts overflow handling to the counted-loss
        contract: drops are counted, never collected or re-admitted.
        ``stencils`` (e.g. ``cuda_solver.make_stencils(grid)``, K1 + K8)
        selects the unfused step; ``planar_rebin=True`` the plane-at-a-time
        rebin (K6 + K7, bitwise the fused rebin's result, lower peak
        memory); ``code_dtype`` its code plane's type.  See
        ``make_step_parts``.  A planar Session's next rebin consumes its
        ``sim``: a DenseSim read from ``self.sim`` loses its planes then,
        so copy the tensors to keep a snapshot.

        The very-large-N knobs: ``init_chunks=K`` builds the dense state
        with ``init_dense_chunked`` (O(N/K) transients, bitwise
        ``init_dense``); ``donate=True`` makes the Session OWN its planes:
        each step writes the new rho into the old rho plane, so a DenseSim
        taken from ``self.sim`` earlier is invalidated by the next step
        (snapshot with ``save`` or ``state()``, or copy its tensors);
        ``refless_trigger=True`` drops the two reference planes for a
        conservative summed-displacement trigger (NOT bitwise the
        ref-based trigger: rebins fire somewhat earlier; the physics is the
        same); ``segmented=True`` runs ``step_until`` segments and each
        rebin apart (bitwise the standard run).

        ``planar_rebin``, ``refless_trigger`` and ``segmented`` left None
        are chosen from the card's memory (``planar_rebin_default``,
        ``refless_trigger_default``, ``segmented_run_default``, on
        plane-footprints measured on an H100).  All of them are off below
        the card's memory wall (at 1M particles, say) and on a CPU device.
        Unlike the reference, the fused K2 stays at the wall: the
        two-kernel tail (K1 + K8 + ``cuda_solver.integrate_into``) peaked
        higher than K2 on the card (PERF.md)."""
        self._setup(params, cfg, grid, state.n, device, stencils, max_age,
                    spill_cap, recovery, planar_rebin, code_dtype,
                    init_chunks, donate, refless_trigger, segmented)
        self.reset(state)

    @classmethod
    def from_generator(cls, gen, n: int, params: FluidParams,
                       cfg: IntegrateConfig, grid: GridSpec2D, *,
                       device="cuda", stencils=None, max_age: int = 64,
                       spill_cap: int = SPILL_CAP, recovery: bool = True,
                       planar_rebin: bool | None = None,
                       code_dtype=torch.int32, init_chunks: int = 16,
                       donate: bool = True,
                       refless_trigger: bool | None = None,
                       segmented: bool | None = None) -> "Session":
        """A Session whose initial scene ``gen`` COMPUTES chunk by chunk
        (``init_dense_gen``; e.g. ``core.state.lattice_gen``) instead of
        binning a FluidState: no [N] particle tensor ever exists on the
        device.  The memory-ceiling path; its defaults are the very-large-N
        posture (``init_chunks=16``, ``donate=True``)."""
        self = cls.__new__(cls)
        self._setup(params, cfg, grid, n, device, stencils, max_age,
                    spill_cap, recovery, planar_rebin, code_dtype,
                    init_chunks, donate, refless_trigger, segmented)
        self.sim = init_dense_gen(gen, n, grid, init_chunks, spill_cap,
                                  collect_spill=recovery,
                                  device=self.device)
        self._apply_refless()
        return self

    def _setup(self, params, cfg, grid, n, device, stencils, max_age,
               spill_cap, recovery, planar_rebin, code_dtype, init_chunks,
               donate, refless_trigger, segmented) -> None:
        self.params = params
        self.cfg = cfg
        self.grid = grid
        self.n = n
        self.device = torch.device(device)
        if planar_rebin is None:
            planar_rebin = planar_rebin_default(grid, device=self.device)
        if refless_trigger is None:
            refless_trigger = refless_trigger_default(grid,
                                                      device=self.device)
        if segmented is None:
            segmented = segmented_run_default(grid, device=self.device)
        self.planar_rebin = planar_rebin
        self.refless_trigger = refless_trigger
        self.segmented = segmented
        self.donate = donate
        self._spill_cap = spill_cap
        self._recovery = recovery
        self._init_chunks = init_chunks
        self._fingerprint = _session_fingerprint(
            stencils, max_age, recovery, refless_trigger, code_dtype)
        self._pure_step, self._rebin, self._need = make_step_parts(
            params, cfg, grid, max_age, n=n if recovery else None,
            stencils=stencils, planar=planar_rebin, code_dtype=code_dtype,
            refless=refless_trigger, donate=donate)

    def _apply_refless(self) -> None:
        """Refless posture: swap the fresh reference planes for (1, 1, 1)
        placeholders, so the two plane-footprints are freed at once."""
        if self.refless_trigger:
            self.sim.ref_xd = _ref_placeholder(self.device)
            self.sim.ref_yd = _ref_placeholder(self.device)

    def reset(self, state: FluidState) -> None:
        """Re-seed the resident DenseSim from a per-particle FluidState
        (fresh binning, chunked when the Session was built with
        ``init_chunks``: the rebin age and skin references restart, the
        step counter continues from ``state.step``)."""
        if state.n != self.n:
            raise ValueError(f"reset with n={state.n}, Session built for "
                             f"n={self.n}")
        state = state.to(self.device)
        if self._init_chunks is None:
            self.sim = init_dense(state, self.grid, self._spill_cap,
                                  collect_spill=self._recovery)
        else:
            self.sim = init_dense_chunked(state, self.grid,
                                          self._init_chunks, self._spill_cap,
                                          collect_spill=self._recovery)
        self._apply_refless()

    def run(self, n_steps: int, chunk: int | None = None) -> None:
        """Advance n_steps: per step, rebin if the trigger fired, then the
        step's kernels.  Returns as soon as the last step is enqueued
        (apart from the per-step trigger read).  ``chunk=K`` runs the steps
        as sequential calls of at most K steps, the reference's API: the
        same trajectory bit for bit (for the segmented driver, its segment
        bound)."""
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk={chunk}: want at least 1")
        if self.segmented:
            run_segmented(self, n_steps, chunk, self._pure_step, self._need,
                          self._rebin)
            return
        done = 0
        while done < n_steps:
            k = n_steps - done if chunk is None else min(chunk, n_steps - done)
            self._run(k)
            done += k

    def _run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            if self._need(self.sim):
                self.sim = self._rebin(self.sim)
            self.sim = self._pure_step(self.sim)

    def frame(self, px_per_cell: int = 2,
              mode: str = "density") -> torch.Tensor:
        """uint8 RGB density-field frame [ny*P, nx*P, 3] (row 0 = top) of
        the resident state, no stepping."""
        return raster.field_frame(self.sim.xd, self.sim.yd, self.params,
                                  self.grid, px_per_cell, mode)

    def run_frame(self, substeps: int = 16, px_per_cell: int = 2,
                  mode: str = "density") -> torch.Tensor:
        """``substeps`` steps, then the field frame (the interactive frame
        loop)."""
        self.run(substeps)
        return self.frame(px_per_cell, mode)

    def run_frames(self, n_frames: int, substeps: int = 16,
                   px_per_cell: int = 2,
                   mode: str = "density") -> torch.Tensor:
        """``n_frames`` x (``substeps`` steps + field frame), stacked as
        uint8 [n_frames, H, W, 3]: the same trajectory and frames as
        ``n_frames`` sequential ``run_frame`` calls (the throughput shape:
        offline export, video encode).  Device footprint: n_frames * H * W
        * 3 bytes."""
        return torch.stack([self.run_frame(substeps, px_per_cell, mode)
                            for _ in range(n_frames)])

    def kick(self, x: float, y: float, dir_x: float, dir_y: float,
             impulse: float = IMPULSE) -> None:
        """Drag impulse straight on the resident dense state (float32
        arithmetic throughout); empty slots keep zero velocity."""
        f = np.float32
        sim = self.sim
        vxd, vyd = apply_impulse_arrays(sim.xd, sim.yd, sim.vxd, sim.vyd,
                                        f(x), f(y), f(dir_x), f(dir_y),
                                        f(impulse))
        live = sim.xd < FAR * 0.5
        self.sim = dataclasses.replace(sim, vxd=torch.where(live, vxd, 0.0),
                                       vyd=torch.where(live, vyd, 0.0))

    def state(self) -> FluidState:
        """Materialize the per-particle FluidState (on demand only)."""
        x, y, vx, vy, rho = extract_fields(self.sim, self.grid, self.params,
                                           self.n)
        z = torch.zeros_like(x)
        return FluidState(x=x, y=y, vx=vx, vy=vy, ax=z, ay=z.clone(),
                          rho=rho, p=eos_pressure(rho, self.params),
                          step=self.sim.step)

    def save(self, path: str) -> None:
        """Snapshot the RESIDENT DenseSim (slot structure, skin references,
        counters) with the grid, params, cfg, particle count and the solver
        knobs' fingerprint (``utils/checkpoint.save_dense``, the reference's
        npz format): ``Session.restore`` continues bitwise, where a reset
        from ``state()`` would re-sort and restart the rebin schedule."""
        from ..utils import checkpoint
        checkpoint.save_dense(path, self.sim, self.grid, self.params,
                              self.cfg, self.n, fingerprint=self._fingerprint)

    @classmethod
    def restore(cls, path: str, *, device="cuda", stencils=None,
                max_age: int = 64, recovery: bool = True,
                planar_rebin: bool | None = None, code_dtype=torch.int32,
                refless_trigger: bool | None = None,
                segmented: bool | None = None,
                donate: bool = False) -> "Session":
        """A Session from ``save`` (or the reference's ``Session.save``),
        its planes on ``device``.  The solver knobs are supplied again and
        must match the artifact's fingerprint, or ValueError: a mismatch
        would continue on a diverging trajectory.  ``refless_trigger=None``
        resolves through ``refless_trigger_default`` BEFORE the check, so
        a ceiling-posture artifact restores without naming it.  The planar
        rebin, donation and the segmented driver are bit-neutral."""
        from ..utils import checkpoint
        device = torch.device(device)
        sim, grid, params, cfg, n = checkpoint.load_dense(path, device)
        if refless_trigger is None:
            refless_trigger = refless_trigger_default(grid, device=device)
        checkpoint.check_fingerprint(
            checkpoint.load_fingerprint(path),
            _session_fingerprint(stencils, max_age, recovery,
                                 refless_trigger, code_dtype),
            "Session.restore")
        self = cls.__new__(cls)
        self._setup(params, cfg, grid, n, device, stencils, max_age,
                    SPILL_CAP, recovery, planar_rebin, code_dtype, None,
                    donate, refless_trigger, segmented)
        self._spill_cap = sim.sx.shape[0]
        self.sim = sim
        return self

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
