"""Hand-written CUDA stencil kernels for the SPH density, the forces (fused
with the integrate step, or alone) and the one-launch "mono" step, with
their plain PyTorch twins; and the eager solver that steps on K1 + K8.

Port of ``bevy_gpu_fluid_tpu/models/pallas_solver.py`` (the TPU Pallas
kernels and its eager ``step``/``multi_step``):

* K1 ``density_cuda`` (``csrc/density.cu``) replaces ``_density_kernel`` /
  ``density_pallas`` (pallas_solver.py:224, :854), ``out=`` its
  ``rho_out`` (the new rho written into a dead plane);
* K2 ``forces_integrate_cuda`` (``csrc/forces_integrate.cu``) replaces
  ``_forces_integrate_kernel`` / ``forces_integrate_pallas``
  (pallas_solver.py:400, :961), both triggers: ref-based, and
  ``refless=True`` (the step's own largest displacement, no reference
  planes read), and its lane window ``disp_lanes`` (the sharded solver's
  real columns);
* K5 ``mono_step_cuda`` (``csrc/mono_step.cu``) replaces
  ``_mono_step_kernel`` / ``mono_step_pallas`` (pallas_solver.py:657,
  :1044): K1 + EOS + K2 in one launch, for grids under
  ``MONO_MAX_BLOCKS`` row blocks;
* K8 ``forces_cuda`` (``csrc/forces.cu``) replaces ``_forces_kernel`` /
  ``forces_pallas`` (pallas_solver.py:296, :930): K2's pair loop alone,
  writing the accelerations.  ``make_stencils`` pairs K1 and K8 for the
  eager step glue of ``models/grid_solver.py`` (``step``, ``multi_step``
  here), the validator and the Session's unfused step.

The dense plane is float32 ``[ny_pad, cap, nx_pad]`` (ops/binning.py).
The kernels loop over the 3x3 neighbour cells x ``kmax`` slots in
(kj, dx, dy) order, with ``kmax`` the per-row-block bound from ``occ``
(ops/reslot.block_kmax3; K5 widens it for its density, see
``mono_bounds``); slots past a cell's occupancy hold FAR and add exactly 0
to a live slot.  The four kernels here stage a tile of cells in shared
memory and work only on live slots, up to the largest count of their 3x3
cells, writing the dead slots' outputs from the counts
(``csrc/bgf_common.cuh``): so their ``occ`` must bound every cell's
occupancy, as ``block_kmax3`` does.
Neighbour columns wrap modulo ``nx_pad`` like the TPU lane roll.  Each
wrapper owns the ghost-block fills of its outputs (rho 0, positions FAR,
velocities 0): a garbage or NaN ghost row would poison the neighbouring
real rows through p_j.

On a CPU tensor a wrapper computes with its twin; on a CUDA tensor it
launches its kernel (and counts the launch) or raises.  The twins are
written in the kernels' own form — the softened force gate and
1/max(rho, 1e-12), the (kj, dx, dy) sum order, the same per-row slot
bound — so kernel and twin differ only by FMA contraction on the card.
The physics constants are float32 and derived in float32 in the Pallas
kernels' operation order (``_density_consts``, ``_forces_consts``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import FluidParams, GRAVITY_Y, GridSpec2D, IntegrateConfig
from ..kernels import _build
from ..ops.binning import FAR
from ..ops.kernels import PI
from ..ops.reslot import block_kmax3, row_kmax, slab_rows, taps
from . import grid_solver

_f32 = np.float32
EPS2 = _f32(1e-6 * 1e-6)   # softening of the force gate, EPS^2

# The flagship step runs K5 below this many row blocks and K1 + K2 from it
# on: the reference package's threshold (pallas_solver._MONO_MAX_BLOCKS),
# which it measured on a TPU v5e.  chip_smoke.py times K5 against K1 + K2
# on the card; moving the threshold is a decision for a measurement.
MONO_MAX_BLOCKS = 12


def _density_consts(params: FluidParams):
    """(h^2, m * 4 / (pi h^8)) in float32, as pallas_solver.py:262, 293."""
    h2 = params.h * params.h
    return h2, (params.m * _f32(4.0)) / (PI * (h2 * h2) * (h2 * h2))


def _forces_consts(params: FluidParams) -> dict:
    """Pair-loop constants in float32, as pallas_solver.py:515-518, 572-574:
    ``m_half = -m * 0.5``, ``spiky_c = -10 / (pi h^5)`` and
    ``visc_mc = mu * m * 40 / (pi h^5)``."""
    h = params.h
    h5 = (h * h) * (h * h) * h
    visc_c = _f32(40.0) / (PI * h5)
    return dict(h=h, m_half=-params.m * _f32(0.5),
                spiky_c=_f32(-10.0) / (PI * h5),
                visc_mc=params.mu * params.m * visc_c)


# ---------------------------------------------------------------------------
# Twin building blocks: the pair sums and the integrate epilogue, shared by
# the K1, K2 and K5 twins so that the three compute the same arithmetic.
# ``tap_fn(kj)`` yields the neighbour views of slot kj in (dx, dy) order;
# ``bound`` is the slot-loop bound broadcastable against the i-view.
# ---------------------------------------------------------------------------

def density_sum(xi, yi, h2, bound, tap_fn, n_kj: int) -> torch.Tensor:
    """sum max(h^2 - r^2, 0)^3 in (kj, dx, dy) order over kj < bound, at
    the points (xi, yi) (broadcast together: slots, or the field raster's
    pixel centres)."""
    rho = torch.zeros(torch.broadcast_shapes(xi.shape, yi.shape),
                      dtype=torch.float32, device=xi.device)
    for kj in range(n_kj):
        on = kj < bound
        for rx, ry in tap_fn(kj):
            ddx = xi - rx
            ddy = yi - ry
            d = torch.clamp_min(float(h2) - (ddx * ddx + ddy * ddy), 0.0)
            rho = torch.where(on, rho + d * d * d, rho)
    return rho


def _eos(rho, params: FluidParams):
    """(p, 1/rho) as the kernels derive them: k * max(rho - rho0, 0) and
    1 / max(rho, 1e-12)."""
    p = float(params.k) * torch.clamp_min(rho - float(params.rho_0), 0.0)
    return p, 1.0 / torch.clamp_min(rho, 1e-12)


def _force_sum(xi, yi, vxi, vyi, p_i, params: FluidParams, bound, tap_fn,
               n_kj: int):
    """Pressure + viscosity accelerations (ax, ay) in (kj, dx, dy) order
    over kj < bound; ``tap_fn`` yields (x, y, vx, vy, p, 1/rho) views."""
    c = _forces_consts(params)
    h, m_half, spiky_c, visc_mc = (float(c[k]) for k in
                                   ("h", "m_half", "spiky_c", "visc_mc"))
    ax = torch.zeros_like(xi)
    ay = torch.zeros_like(xi)
    for kj in range(n_kj):
        on = kj < bound
        for rx, ry, rvx, rvy, rp, ri in tap_fn(kj):
            ddx = xi - rx
            ddy = yi - ry
            r2 = ddx * ddx + ddy * ddy
            inv_r = torch.rsqrt(r2 + float(EPS2))
            hr = torch.clamp_min(h - r2 * inv_r, 0.0)
            fac_p = m_half * (p_i + rp) * ri * (spiky_c * hr * hr * inv_r)
            fac_v = visc_mc * ri * hr
            ax = torch.where(on, ax + (fac_p * ddx + fac_v * (rvx - vxi)), ax)
            ay = torch.where(on, ay + (fac_p * ddy + fac_v * (rvy - vyi)), ay)
    return ax, ay


def integrate(xi, yi, vxi, vyi, ax, ay, ref_x, ref_y, cfg: IntegrateConfig,
              lanes=None):
    """Semi-implicit Euler + gravity + bounce box, masked to live slots
    (x < 1e8), and the max squared displacement of the live slots from the
    rebin reference (``ref_x is xi``: from the old positions, the refless
    trigger's step maximum), over the lanes (last axis) [lo, hi) of
    ``lanes`` when given.  Returns (x, y, vx, vy, disp2)."""
    dt = float(cfg.dt)
    bounce = float(cfg.bounce)
    live = xi < 1e8
    vx = vxi + ax * dt
    vy = vyi + (ay + GRAVITY_Y) * dt
    x = xi + vx * dt
    y = yi + vy * dt
    below = y < float(cfg.floor_y)
    y = torch.where(below, float(cfg.floor_y), y)
    vy = torch.where(below, vy * bounce, vy)
    right = x > float(cfg.x_max)
    x = torch.where(right, float(cfg.x_max), x)
    vx = torch.where(right, vx * bounce, vx)
    left = x < float(cfg.x_min)
    x = torch.where(left, float(cfg.x_min), x)
    vx = torch.where(left, vx * bounce, vx)
    x = torch.where(live, x, xi)
    y = torch.where(live, y, yi)
    vx = torch.where(live, vx, 0.0)
    vy = torch.where(live, vy, 0.0)
    drx = x - ref_x
    dry = y - ref_y
    if lanes is not None:
        lane = torch.arange(xi.shape[-1], device=xi.device)
        live = live & (lane >= lanes[0]) & (lane < lanes[1])
    disp2 = torch.where(live, drx * drx + dry * dry, 0.0).amax()
    return x, y, vx, vy, disp2


def integrate_into(xi, yi, vxi, vyi, ax, ay, ref_x, ref_y,
                   cfg: IntegrateConfig, refless: bool = False, lanes=None):
    """``integrate`` of the unfused step's tail with the accelerations'
    planes as the velocities' outputs: ``ax`` and ``ay`` are TAKEN and come
    back holding vx and vy, x and y are new planes, and the arithmetic runs
    in row slabs (``ops.reslot.slab_rows``), so its temporaries are a
    slab's, not a plane's.  The same values as
    ``integrate`` bit for bit (elementwise, and a max).  ``refless``:
    the displacement is from the old positions (``ref_x``/``ref_y`` are
    not read); ``lanes`` as ``integrate``'s (a slab's real columns).
    Returns (x, y, vx, vy, disp2)."""
    if refless:
        ref_x, ref_y = xi, yi
    x = torch.empty_like(xi)
    y = torch.empty_like(yi)
    rows = slab_rows(xi.shape)
    disp = []
    for r in range(0, xi.shape[0], rows):
        sl = slice(r, r + rows)
        xs, ys, vxs, vys, d = integrate(xi[sl], yi[sl], vxi[sl], vyi[sl],
                                        ax[sl], ay[sl], ref_x[sl],
                                        ref_y[sl], cfg, lanes)
        x[sl], y[sl], ax[sl], ay[sl] = xs, ys, vxs, vys
        disp.append(d)
    return x, y, ax, ay, torch.stack(disp).amax()


# ---------------------------------------------------------------------------
# K1: density
# ---------------------------------------------------------------------------

def density_torch(xd, yd, params: FluidParams, grid: GridSpec2D,
                  occ) -> torch.Tensor:
    """Plain PyTorch twin of kernel K1: rho = coeff * sum max(h^2 - r^2,
    0)^3 in (kj, dx, dy) order; ghost blocks 0."""
    h2, coeff = _density_consts(params)
    kmax = row_kmax(occ, grid)
    rho = density_sum(xd, yd, h2, kmax, lambda kj: taps((xd, yd), kj),
                      int(kmax.max()))
    return rho * float(coeff)


def density_cuda(xd, yd, params: FluidParams, grid: GridSpec2D,
                 occ, out=None) -> torch.Tensor:
    """Density stencil over the dense grid (kernel K1).  ``occ`` is the
    sim's cached ``block_kmax3``.  Returns rho_d with ghost blocks 0:
    written into ``out`` (a dead float32 plane, the reference's
    ``rho_out``; every slot is written) when given, else a new plane.
    ``launches`` counts every launch, ``launches_out`` those into ``out``."""
    planes = dict(xd=xd, yd=yd) if out is None else dict(xd=xd, yd=yd,
                                                          out=out)
    dev = _build.check_planes(grid, occ, **planes)
    if dev.type == "cpu":
        rho = density_torch(xd, yd, params, grid, occ)
        return rho if out is None else out.copy_(rho)
    h2, coeff = _density_consts(params)
    rho = torch.empty_like(xd) if out is None else out
    _build.launch("bgf_density", dev, xd.data_ptr(), yd.data_ptr(),
                  occ.data_ptr(), rho.data_ptr(), grid.ny_pad, grid.cap,
                  grid.nx_pad, grid.row_block, grid.n_row_blocks, float(h2),
                  float(coeff))
    density_cuda.launches += 1
    density_cuda.launches_out += int(out is not None)
    return rho


density_cuda.launches = 0
density_cuda.launches_out = 0


# ---------------------------------------------------------------------------
# K2: forces + integrate + bounce + skin displacement
# ---------------------------------------------------------------------------

def forces_integrate_torch(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                           params: FluidParams, cfg: IntegrateConfig,
                           grid: GridSpec2D, occ, refless: bool = False,
                           disp_lanes=None):
    """Plain PyTorch twin of kernel K2.  Returns (xd', yd', vxd', vyd',
    disp2) with disp2 a float32 0-dim tensor; ``refless``: disp2 from the
    old positions (``ref_xd``/``ref_yd`` are not read); ``disp_lanes``
    (lo, hi): disp2 over those lanes only."""
    if refless:
        ref_xd, ref_yd = xd, yd
    p, ir = _eos(rho_d, params)
    kmax = row_kmax(occ, grid)
    ax, ay = _force_sum(xd, yd, vxd, vyd, p, params, kmax,
                        lambda kj: taps((xd, yd, vxd, vyd, p, ir), kj),
                        int(kmax.max()))
    x, y, vx, vy, disp2 = integrate(xd, yd, vxd, vyd, ax, ay, ref_xd, ref_yd,
                                    cfg, disp_lanes)
    tb = grid.row_block
    for plane, fill in ((x, FAR), (y, FAR), (vx, 0.0), (vy, 0.0)):
        plane[:tb] = fill
        plane[-tb:] = fill
    return x, y, vx, vy, disp2


def forces_integrate_cuda(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                          params: FluidParams, cfg: IntegrateConfig,
                          grid: GridSpec2D, occ, refless: bool = False,
                          disp_lanes=None):
    """Fused forces + integrate + bounce + skin-displacement pass (kernel
    K2).  Returns (xd', yd', vxd', vyd', disp2): new planes with FAR/0
    ghost blocks, and the max squared displacement of the new live
    positions from the rebin reference as a float32 0-dim tensor (the next
    step's rebin trigger).  ``refless=True``: the displacement is from the
    old positions (this step's move; the refless trigger sums the square
    roots), and ``ref_xd``/``ref_yd`` are not read: None or the (1, 1, 1)
    placeholders of the refless posture.  ``disp_lanes=(lo, hi)`` takes
    the max over the lanes [lo, hi) only (a slab's real columns; the
    reference's ``disp_lanes``), every lane by default.  ``launches``
    counts every form, ``launches_refless`` the refless ones,
    ``launches_lanes`` those with a lane window and
    ``launches_refless_lanes`` those with both (the sharded refless
    trigger's)."""
    refs = {} if refless else dict(ref_xd=ref_xd, ref_yd=ref_yd)
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              rho_d=rho_d, **refs)
    lo, hi = (0, grid.nx_pad) if disp_lanes is None else disp_lanes
    if not 0 <= lo <= hi <= grid.nx_pad:
        raise ValueError(f"disp_lanes {disp_lanes} outside [0, "
                         f"{grid.nx_pad}]")
    if dev.type == "cpu":
        return forces_integrate_torch(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                                      params, cfg, grid, occ, refless,
                                      disp_lanes)
    c = _forces_consts(params)
    outs = [torch.empty_like(xd) for _ in range(4)]
    disp = torch.empty(1, dtype=torch.float32, device=dev)
    _build.launch(
        "bgf_forces_integrate", dev, xd.data_ptr(), yd.data_ptr(),
        vxd.data_ptr(), vyd.data_ptr(), rho_d.data_ptr(),
        0 if refless else ref_xd.data_ptr(),
        0 if refless else ref_yd.data_ptr(), occ.data_ptr(),
        *(o.data_ptr() for o in outs), disp.data_ptr(), grid.ny_pad,
        grid.cap, grid.nx_pad, grid.row_block, grid.n_row_blocks,
        int(refless), lo, hi,
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k), float(cfg.dt),
        float(cfg.x_min), float(cfg.x_max), float(cfg.bounce),
        float(cfg.floor_y))
    forces_integrate_cuda.launches += 1
    forces_integrate_cuda.launches_refless += int(refless)
    forces_integrate_cuda.launches_lanes += int(disp_lanes is not None)
    forces_integrate_cuda.launches_refless_lanes += int(
        refless and disp_lanes is not None)
    return (*outs, disp[0])


forces_integrate_cuda.launches = 0
forces_integrate_cuda.launches_refless = 0
forces_integrate_cuda.launches_lanes = 0
forces_integrate_cuda.launches_refless_lanes = 0


# ---------------------------------------------------------------------------
# K5: the mono step (K1 + EOS + K2 in one launch)
# ---------------------------------------------------------------------------

def mono_bounds(occ: torch.Tensor, grid: GridSpec2D):
    """Per-row-block slot bounds of the mono step, int64 [nb] each:
    ``kmax_d`` for the density of the block's rows and its one-row halo
    (the block's three shifts plus the outermost shift of each neighbouring
    block, clamped at the grid edge; pallas_solver.py:721-733) and
    ``kmax_f`` for the forces (the block's three shifts, as K2)."""
    nb = grid.n_row_blocks
    o = occ.to(torch.int64)
    r = torch.arange(nb, device=occ.device)
    kmax_f = o.amax(dim=0)
    kmax_d = torch.maximum(kmax_f, torch.maximum(
        o[0, torch.clamp_min(r - 1, 0)], o[2, torch.clamp_max(r + 1, nb - 1)]))
    return kmax_d, kmax_f


def _row_windows(plane, grid: GridSpec2D, start: int, rows: int):
    """[nb, rows, cap, nx_pad]: window r holds the plane rows
    (r+1)*tb + start ... + rows - 1 (a row block and its halo)."""
    tb, nb = grid.row_block, grid.n_row_blocks
    dev = plane.device
    idx = ((torch.arange(nb, device=dev) + 1) * tb + start)[:, None] \
        + torch.arange(rows, device=dev)[None, :]
    return plane[idx]


def _window_taps(windows, kj: int, n: int):
    """Neighbour views of slot kj over row windows, in (dx, dy) order:
    ``windows`` holds (window, i_row) pairs, and the view at row shift dy
    is the window's rows i_row + dy ... + n - 1; columns wrap modulo
    nx_pad like the TPU lane roll."""
    slot = [(w[:, :, kj:kj + 1, :], i) for w, i in windows]
    for dx in (-1, 0, 1):
        rolled = [(torch.roll(s, -dx, 3), i) for s, i in slot]
        for dy in (-1, 0, 1):
            yield [r[:, i + dy:i + dy + n] for r, i in rolled]


def mono_step_torch(xd, yd, vxd, vyd, ref_xd, ref_yd, params: FluidParams,
                    cfg: IntegrateConfig, grid: GridSpec2D, occ):
    """Plain PyTorch twin of kernel K5, in the Pallas kernel's form: per
    interior row block, the density of its tb rows plus one halo row each
    side from a (tb+4)-row x/y window under ``kmax_d``, then EOS, forces
    under ``kmax_f``, Euler, bounce and the displacement.  Returns (xd',
    yd', vxd', vyd', rho_d, disp2); ghost blocks FAR/FAR/0/0/0, disp2 a
    float32 0-dim tensor.  A dead slot inside ``kmax_d`` sums its FAR-FAR
    pairs, so rho_d differs from K1's on dead slots only."""
    tb, nb = grid.row_block, grid.n_row_blocks
    kmax_d, kmax_f = mono_bounds(occ, grid)
    kd = kmax_d[:, None, None, None]
    kf = kmax_f[:, None, None, None]
    h2, coeff = _density_consts(params)
    td = tb + 2
    xw = _row_windows(xd, grid, -2, tb + 4)
    yw = _row_windows(yd, grid, -2, tb + 4)
    rho = density_sum(
        xw[:, 1:1 + td], yw[:, 1:1 + td], h2, kd,
        lambda kj: _window_taps(((xw, 1), (yw, 1)), kj, td),
        int(kmax_d.max())) * float(coeff)
    p, ir = _eos(rho, params)
    vxw = _row_windows(vxd, grid, -1, td)
    vyw = _row_windows(vyd, grid, -1, td)
    xi, yi = xw[:, 2:2 + tb], yw[:, 2:2 + tb]
    vxi, vyi = vxw[:, 1:1 + tb], vyw[:, 1:1 + tb]
    ax, ay = _force_sum(
        xi, yi, vxi, vyi, p[:, 1:1 + tb], params, kf,
        lambda kj: _window_taps(((xw, 2), (yw, 2), (vxw, 1), (vyw, 1),
                                 (p, 1), (ir, 1)), kj, tb),
        int(kmax_f.max()))
    x, y, vx, vy, disp2 = integrate(
        xi, yi, vxi, vyi, ax, ay, _row_windows(ref_xd, grid, 0, tb),
        _row_windows(ref_yd, grid, 0, tb), cfg)

    def plane(blocks, fill):
        out = torch.full(grid.plane_shape, fill, dtype=torch.float32,
                         device=xd.device)
        out[tb:tb + nb * tb] = blocks.reshape(nb * tb, grid.cap, grid.nx_pad)
        return out
    return (plane(x, FAR), plane(y, FAR), plane(vx, 0.0), plane(vy, 0.0),
            plane(rho[:, 1:1 + tb], 0.0), disp2)


def mono_step_cuda(xd, yd, vxd, vyd, ref_xd, ref_yd, params: FluidParams,
                   cfg: IntegrateConfig, grid: GridSpec2D, occ):
    """One whole step in one launch (kernel K5); same contract as
    ``mono_step_torch``.  ``occ`` is the sim's cached ``block_kmax3``."""
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              ref_xd=ref_xd, ref_yd=ref_yd)
    if dev.type == "cpu":
        return mono_step_torch(xd, yd, vxd, vyd, ref_xd, ref_yd, params, cfg,
                               grid, occ)
    h2, coeff = _density_consts(params)
    c = _forces_consts(params)
    outs = [torch.empty_like(xd) for _ in range(5)]
    disp = torch.empty(1, dtype=torch.float32, device=dev)
    _build.launch(
        "bgf_mono_step", dev, xd.data_ptr(), yd.data_ptr(), vxd.data_ptr(),
        vyd.data_ptr(), ref_xd.data_ptr(), ref_yd.data_ptr(), occ.data_ptr(),
        *(o.data_ptr() for o in outs), disp.data_ptr(), grid.ny_pad,
        grid.cap, grid.nx_pad, grid.row_block, grid.n_row_blocks,
        float(c["h"]), float(h2), float(coeff),
        *(float(c[k]) for k in ("m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k), float(cfg.dt),
        float(cfg.x_min), float(cfg.x_max), float(cfg.bounce),
        float(cfg.floor_y))
    mono_step_cuda.launches += 1
    return (*outs, disp[0])


mono_step_cuda.launches = 0


# ---------------------------------------------------------------------------
# K8: forces alone (pressure + viscosity accelerations)
# ---------------------------------------------------------------------------

def forces_torch(xd, yd, vxd, vyd, rho_d, params: FluidParams,
                 grid: GridSpec2D, occ):
    """Plain PyTorch twin of kernel K8: K2's pair sum (``_eos``,
    ``_force_sum``, the same per-row bound) without the integrate.  Returns
    (ax_d, ay_d); ghost blocks 0."""
    p, ir = _eos(rho_d, params)
    kmax = row_kmax(occ, grid)
    return _force_sum(xd, yd, vxd, vyd, p, params, kmax,
                      lambda kj: taps((xd, yd, vxd, vyd, p, ir), kj),
                      int(kmax.max()))


def forces_cuda(xd, yd, vxd, vyd, rho_d, params: FluidParams,
                grid: GridSpec2D, occ):
    """Pressure + viscosity accelerations over the dense grid (kernel K8),
    EOS and 1/rho derived in the kernel; no gravity.  ``occ`` bounds the
    slot loops (``block_kmax3`` of the planes).  Returns (ax_d, ay_d); the
    ghost blocks, which the TPU kernel leaves unwritten, hold 0."""
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              rho_d=rho_d)
    if dev.type == "cpu":
        return forces_torch(xd, yd, vxd, vyd, rho_d, params, grid, occ)
    c = _forces_consts(params)
    ax = torch.empty_like(xd)
    ay = torch.empty_like(xd)
    _build.launch(
        "bgf_forces", dev, xd.data_ptr(), yd.data_ptr(), vxd.data_ptr(),
        vyd.data_ptr(), rho_d.data_ptr(), occ.data_ptr(), ax.data_ptr(),
        ay.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks,
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k))
    forces_cuda.launches += 1
    return ax, ay


forces_cuda.launches = 0


# ---------------------------------------------------------------------------
# The eager solver: sort-based binning every step, K1 + K8
# ---------------------------------------------------------------------------

def make_stencils(grid: GridSpec2D):
    """(density_fn, forces_fn) on K1 and K8, pluggable into
    ``grid_solver``'s step glue and ``verlet_solver``'s unfused step.  Both
    take an optional ``occ=`` (``block_kmax3`` bounds) and compute it from
    the planes when none is given; ``density_fn`` also takes ``out=`` (K1
    writing into a dead plane; its ``takes_out`` attribute says so)."""
    def density_fn(xd, yd, params, occ=None, out=None):
        if occ is None:
            occ = block_kmax3(xd, grid)
        return density_cuda(xd, yd, params, grid, occ, out=out)

    density_fn.takes_out = True

    def forces_fn(xd, yd, vxd, vyd, rho_d, params, occ=None):
        if occ is None:
            occ = block_kmax3(xd, grid)
        return forces_cuda(xd, yd, vxd, vyd, rho_d, params, grid, occ)
    return density_fn, forces_fn


def step_with_diag(state, params: FluidParams, cfg: IntegrateConfig,
                   grid: GridSpec2D):
    """One eager step on K1 + K8 (re-binned by sort), with its StepDiag."""
    return grid_solver.step_with_diag(state, params, cfg, grid,
                                      stencils=make_stencils(grid))


def step(state, params: FluidParams, cfg: IntegrateConfig, grid: GridSpec2D):
    return step_with_diag(state, params, cfg, grid)[0]


def multi_step(state, params: FluidParams, cfg: IntegrateConfig,
               grid: GridSpec2D, n_steps: int):
    """n_steps eager steps on K1 + K8; returns (state, StepDiag) with the
    largest per-step overflow."""
    return grid_solver.multi_step(state, params, cfg, grid, n_steps,
                                  stencils=make_stencils(grid))
