"""The reference's kernel experiments as hand-written CUDA kernels, with
their plain PyTorch twins: design studies of K1, K2 and K8 that no
production path runs (the tools ``bevy_gpu_fluid_tpu_torch/tools/exp_*.py``
and ``chip_smoke.py`` drive them against their production counterparts).

Port of the Pallas kernels of the repo's ``tools/exp_*.py``:

* T1 ``forces_integrate_dbuf_cuda`` (``csrc/exp_dbuf.cu``) replaces
  ``_dbuf_kernel`` / ``make_dbuf`` (tools/exp_dbuf.py:38, :169): K2's
  ref-based function as a persistent kernel whose producer warp copies the
  next tile's window by TMA boxes into a shared-memory stage once its
  consumer warps have repacked the current one, while they compute it;
  bitwise K2;
* T2 ``density_t_cuda`` (``csrc/exp_tlayout.cu``) replaces
  ``_density_kernel_t`` / ``density_t`` (tools/exp_tlayout.py:37, :182):
  K1 on SLOT-MAJOR planes ``[cap, ny_pad, nx_pad]``, taps in (kj, dx, dy)
  order; bitwise K1 after ``movedim``; the walk tile (below);
* T3 ``forces_t_cuda`` (``csrc/exp_tlayout.cu``) replaces
  ``_forces_kernel_t`` / ``forces_t`` (tools/exp_tlayout.py:84, :158): K8
  on slot-major planes, staged by the same TMA stage, taps in (kj, dy, dx)
  order, so it rounds differently from K8;
* T4 ``forces_variant_cuda`` (``csrc/exp_forces.cu``) replaces
  ``_forces_kernel_v`` / ``make_forces`` (tools/exp_forces.py:47, :235):
  K8 in the five arithmetic variants of ``VARIANTS`` (v0 is K8's own
  arithmetic and bitwise K8; v0nr trades the rsqrt for ``r^2 + EPS``,
  wrong physics that prices the rsqrt; v1 folds the constants; v2 also
  factors v_i out of the pair loop; v3 is v2 with the slot-layer loop
  unrolled by two, bitwise v2); the walk tile.

The slot-major planes hold the dense planes' cells, ghost blocks and FAR
sentinel with the slot axis first (``to_slot_major``); their slot-loop
bounds are the dense planes' ``block_kmax3`` (``block_kmax3_t``).  As the
production wrappers, each wrapper computes with its twin on a CPU tensor
and launches its kernel (counting the launch) or raises on a CUDA one.
The twins repeat the TPU kernels' float operations in their order; the
kernels differ from them by FMA contraction only.

T2 and T4 share the walk tile of ``csrc/bgf_walk.cuh``: 4 x 28-cell tiles
from column 1, the window staged in aligned 16-byte chunks into a
column-major shared window, and a thread per (cell, slot pair) that taps
its cell's candidates below the largest of the 9 counts, each loaded once
for both slots.  ``walk_plan`` mirrors its layout and ``walk_items`` its
item list, for the CPU tests.

T1 and T3 lay out their TMA stage on the C side; ``dbuf_plan`` and
``forces_t_plan`` mirror that layout (a ``TmaPlan``) for the CPU tests to
pin on every plane shape the repo runs, and a card test holds the mirror
to the C side's shared memory and blocks per SM.  Each plane is a 3D
tensor for the copy engine (dims innermost first, byte strides of the
outer two), a field's window one box per slot of 32 columns (128 bytes; a
tile is 28 columns from column 1 on, so the box starts 16-byte aligned, as
TMA needs) x the tile's rows + 2; the stage holds every field's window of
one tile at ``cap`` slots, and the kernel repacks it into the packed
window its taps read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import numpy as np
import torch

from ..core.params import FluidParams, GridSpec2D, IntegrateConfig
from ..kernels import _build
from ..ops.reslot import block_kmax3, row_kmax, taps
from . import cuda_solver
from .cuda_solver import EPS2, _density_consts, _eos, _force_sum, \
    _forces_consts, density_sum

VARIANTS = ("v0", "v0nr", "v1", "v2", "v3")
EPS_NR = np.float32(1e-6)   # v0nr's r^2 + EPS in place of the rsqrt


def to_slot_major(plane: torch.Tensor) -> torch.Tensor:
    """A dense plane [ny_pad, cap, nx_pad] as a new slot-major one."""
    return plane.movedim(1, 0).contiguous()


def from_slot_major(plane: torch.Tensor) -> torch.Tensor:
    """A slot-major plane [cap, ny_pad, nx_pad] as a new dense one."""
    return plane.movedim(0, 1).contiguous()


def slot_major_shape(grid: GridSpec2D) -> tuple:
    return (grid.cap, grid.ny_pad, grid.nx_pad)


def block_kmax3_t(xt: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """``block_kmax3`` of a slot-major x plane (the TPU tool's
    ``block_kmax3(moveaxis(xt, 0, 1))``)."""
    return block_kmax3(xt.movedim(0, 1), grid)


def _taps_t(planes, kj: int, order: str):
    """Neighbour views of slot ``kj`` of slot-major planes, [1, ny_pad,
    nx_pad] each, rows and columns wrapping: in (dx, dy) order for
    ``order="dxdy"`` (K1's), in (dy, dx) order for "dydx" (the TPU forces
    kernel's)."""
    slot = [p[kj:kj + 1] for p in planes]
    if order == "dxdy":
        for dx in (-1, 0, 1):
            rolled = [torch.roll(s, -dx, 2) for s in slot]
            for dy in (-1, 0, 1):
                yield [torch.roll(r, -dy, 1) for r in rolled]
    else:
        for dy in (-1, 0, 1):
            shifted = [torch.roll(s, -dy, 1) for s in slot]
            for dx in (-1, 0, 1):
                yield [torch.roll(r, -dx, 2) for r in shifted]


def _row_bound_t(occ, grid: GridSpec2D) -> torch.Tensor:
    """The per-row slot bound [1, ny_pad, 1] of slot-major planes."""
    return row_kmax(occ, grid).view(1, grid.ny_pad, 1)


# ---------------------------------------------------------------------------
# The TMA stage of T1 and T3: the layout the C side lays out, mirrored
# ---------------------------------------------------------------------------

SM_SMEM = 233_472       # shared memory of one H100 SM (228 KB)
BLOCK_SMEM = 232_448    # the most one block may take (227 KB)
SMEM_RESERVED = 1_024   # the runtime's reserve per resident block
SM_WARPS = 64           # warps one SM holds
TMA_BOX_MAX = 256       # elements a box spans in one dimension, at most
TX_MAX = (1 << 20) - 1  # bytes one mbarrier phase may expect
WIN_COLS = 32           # a window's columns, a box's inner extent
RING_COLS = 28          # tile columns (bgf::kRingCols): tiles start at
                        # column 1, so a window's first column, col0 - 1,
                        # is 16-byte aligned, as a box's must be
SMEM_ALIGN, HEADER_BYTES = 128, 256   # csrc/bgf_tma.cuh
# (tile rows, consumer warps, blocks per SM) of csrc/exp_dbuf.cu and of
# csrc/exp_tlayout.cu's T3 (kRows, kWarps, kMinBlocks)
DBUF_SHAPE = (4, 11, 2)
FORCES_T_SHAPE = (2, 6, 4)


@dataclasses.dataclass(frozen=True)
class TmaPlan:
    """The layout of a T1 or T3 launch, as its C entry point lays it
    out."""
    kernel: str         # "dbuf" (T1) or "forces_t" (T3)
    rows: int           # tile rows (x 28 columns, + a one-cell ring)
    warps: int          # consumer warps (+ one producer warp)
    blocks_per_sm: int  # the blocks it is built for (__launch_bounds__)
    stage_bytes: int    # every field's window of one tile at cap slots
    smem_bytes: int     # the block's dynamic shared memory
    dims: tuple         # a plane's dims, innermost first (elements)
    strides: tuple      # bytes of one step along dims 1 and 2
    box: tuple          # a field's window box (one slot), innermost first
    ref_box: tuple      # the references' box (T1), else zeros
    fields: int         # planes staged by the window box
    ref_fields: int     # planes staged by the references' box

    @property
    def resident_warps(self) -> int:
        """Warps per SM at the blocks per SM it is built for."""
        return self.blocks_per_sm * (self.warps + 1)

    @property
    def box_bytes(self) -> int:
        return 4 * int(np.prod(self.box))

    @property
    def ref_box_bytes(self) -> int:
        return 4 * int(np.prod(self.ref_box))

    def tile_bytes(self, kmax: int) -> int:
        """Bytes the producer stages for a tile of slot bound ``kmax``: a
        box per field and slot below it."""
        return kmax * (self.fields * self.box_bytes
                       + self.ref_fields * self.ref_box_bytes)


def _plan(kernel: str, shape3: tuple, cap: int, dims: tuple,
          strides: tuple, box_of, fields: int, ref_fields: int) -> TmaPlan:
    rows, warps, blocks = shape3
    box = box_of(rows + 2)
    ref_box = box_of(rows) if ref_fields else (0, 0, 0)
    win = (rows + 2) * cap * WIN_COLS
    stage = (fields * win + ref_fields * rows * cap * WIN_COLS) * 4
    # after the stage: the packed (x, y, vx, vy) and (p, 1/rho) windows,
    # T1's (ref_x, ref_y) tile, the window counts, the pair list and its
    # count
    tail = (win * (16 + 8) + (rows * cap * WIN_COLS * 8 if ref_fields
                              else 0)
            + (rows + 2) * WIN_COLS * 4 + (rows * RING_COLS * cap + 1) * 4)
    plan = TmaPlan(kernel, rows, warps, blocks, stage,
                   SMEM_ALIGN + HEADER_BYTES + stage + tail, dims, strides,
                   box, ref_box, fields, ref_fields)
    broken = tma_rules(plan)
    if broken:
        raise ValueError(f"{kernel} at {dims}: {broken}")
    return plan


def tma_rules(plan: TmaPlan) -> list:
    """The rules a plan breaks (none: []): TMA's (global strides multiples
    of 16 bytes below 2^40, dims below 2^32, box extents 1..256, the inner
    box 128 bytes), the stage's bytes within one mbarrier phase, and the
    blocks per SM within an SM's shared memory and warps."""
    broken = []
    if any(s % 16 or s >= 1 << 40 for s in plan.strides):
        broken.append(f"strides {plan.strides}")
    if any(not 0 < d < 1 << 32 for d in plan.dims):
        broken.append(f"dims {plan.dims}")
    for box in (plan.box, plan.ref_box) if plan.ref_fields else (plan.box,):
        if any(not 1 <= b <= TMA_BOX_MAX for b in box) or box[0] * 4 != 128:
            broken.append(f"box {box}")
    if plan.stage_bytes > TX_MAX:
        broken.append(f"stage {plan.stage_bytes} bytes")
    if (plan.smem_bytes > BLOCK_SMEM or plan.blocks_per_sm
            * (plan.smem_bytes + SMEM_RESERVED) > SM_SMEM):
        broken.append(f"{plan.blocks_per_sm} blocks of {plan.smem_bytes} "
                      f"bytes")
    if plan.resident_warps > SM_WARPS:
        broken.append(f"{plan.resident_warps} warps")
    return broken


@functools.lru_cache(maxsize=64)
def dbuf_plan(shape) -> TmaPlan:
    """T1's layout on dense planes ``shape`` = [ny_pad, cap, nx_pad]: each
    plane dims {nx_pad, cap, ny_pad}; the window box {32, 1, rows + 2}, the
    references' {32, 1, rows}; the stage holds the x, y, vx, vy, rho
    windows and the two reference tiles at cap slots."""
    ny_pad, cap, nx_pad = (int(v) for v in shape)
    return _plan("dbuf", DBUF_SHAPE, cap, (nx_pad, cap, ny_pad),
                 (4 * nx_pad, 4 * cap * nx_pad),
                 lambda rows: (WIN_COLS, 1, rows), 5, 2)


@functools.lru_cache(maxsize=64)
def forces_t_plan(shape) -> TmaPlan:
    """T3's layout on the slot-major planes of dense ``shape`` = [ny_pad,
    cap, nx_pad]: each plane dims {nx_pad, ny_pad, cap}; the window box
    {32, rows + 2, 1}; the stage holds the x, y, vx, vy, rho windows at cap
    slots."""
    ny_pad, cap, nx_pad = (int(v) for v in shape)
    return _plan("forces_t", FORCES_T_SHAPE, cap, (nx_pad, ny_pad, cap),
                 (4 * nx_pad, 4 * ny_pad * nx_pad),
                 lambda rows: (WIN_COLS, rows, 1), 5, 0)


def _check_aligned(**planes) -> None:
    """Each plane starts 16-byte aligned, as a tensor map's base and a
    16-byte copy's source must (an offset view may not)."""
    for name, t in planes.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the plane must start 16-byte aligned "
                             f"(TMA boxes and 16-byte copies)")


def plan_occupancy(plan: TmaPlan) -> dict:
    """``_build.occupancy`` of the plan's kernel on the current device, with
    the warps per SM its blocks hold (``resident_warps``)."""
    name = {"dbuf": "forces_integrate_dbuf", "forces_t": "forces_t"}
    cap = plan.dims[1] if plan.kernel == "dbuf" else plan.dims[2]
    o = _build.occupancy(name[plan.kernel], cap)
    return dict(o, resident_warps=o["blocks_per_sm"] * (plan.warps + 1))


# ---------------------------------------------------------------------------
# The walk tile of T2 and T4 (csrc/bgf_walk.cuh), mirrored
# ---------------------------------------------------------------------------

WALK_ROWS = 4        # tile rows (x RING_COLS columns, + a one-cell ring)
WALK_STRIDE = 7      # the window's column stride (kR)
WALK_MAX_CAP = 64    # an item holds its first slot in 6 bits
# slots of a slot layer: 32 columns at the stride, plus one so that the
# layer stride is odd (conflict-free staging)
WALK_LAYER = WIN_COLS * WALK_STRIDE + 1
WALK_SLOTS = 2       # slots a thread
# kernel -> (threads a block, window bytes a slot): T2's (x, y); T4's
# (x, y, vx, vy) and (p, 1/rho)
WALK_KERNELS = {"density_t": (128, 8), "forces_variant": (256, 24)}
SM_BLOCKS = 32       # blocks one SM holds


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """The layout of a T2 or T4 launch, as its C entry point lays it out."""
    kernel: str          # "density_t" (T2) or "forces_variant" (T4)
    shape: tuple         # dense plane shape [ny_pad, cap, nx_pad]
    rows: int            # tile rows
    stride: int          # window column stride (kR)
    threads: int         # threads a block
    window_bytes: int    # the window at cap slot layers; the counts follow
    smem_bytes: int      # the block's dynamic shared memory
    items: int           # item slots of a tile

    @property
    def tile_cols(self) -> list:
        """(col0, cols) of each tile column: 28 columns from column 1."""
        nx_pad = self.shape[2]
        return [(c, min(RING_COLS, nx_pad - c))
                for c in range(1, nx_pad, RING_COLS)]

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM's shared memory and warps hold (registers not
        counted: the card's occupancy says)."""
        return min(SM_SMEM // (self.smem_bytes + SMEM_RESERVED),
                   SM_WARPS // (self.threads // 32), SM_BLOCKS)

    def window_index(self, kj: int, wc: int, wr: int) -> int:
        """Window slot (wr, kj, wc) in the column-major window."""
        return kj * WALK_LAYER + wc * self.stride + wr


@functools.lru_cache(maxsize=64)
def walk_plan(shape, kernel: str) -> WalkPlan:
    """The walk tile's layout of ``kernel`` ("density_t" or
    "forces_variant") on dense planes ``shape`` = [ny_pad, cap, nx_pad]
    (T2's slot-major planes hold the same cells); raises ValueError on what
    the kernel does not take: a cap past ``WALK_MAX_CAP`` (the items'
    slot field), nx_pad not a multiple of 4 (16-byte chunks), a block past
    the SM's shared memory.  The window holds an even number of slots, so
    the counts after it (stored as 16-byte int4s) start 16-byte aligned."""
    ny_pad, cap, nx_pad = (int(v) for v in shape)
    threads, slot_bytes = WALK_KERNELS[kernel]
    if cap > WALK_MAX_CAP or nx_pad % 4:
        raise ValueError(f"{kernel} at {shape}: the walk tile takes cap <= "
                         f"{WALK_MAX_CAP} and nx_pad a multiple of 4")
    win_rows = WALK_ROWS + 2
    items = (WALK_ROWS * RING_COLS * -(-cap // WALK_SLOTS) + 1) & ~1
    window = (WALK_LAYER * cap + cap % 2) * slot_bytes
    dead_rho = WALK_ROWS * WIN_COLS * 4 if kernel == "density_t" else 0
    smem = window + win_rows * WIN_COLS * 4 + dead_rho + items * 2 + 4
    if smem > BLOCK_SMEM:
        raise ValueError(f"{kernel} at {shape}: {smem} bytes of shared "
                         f"memory a block")
    return WalkPlan(kernel, (ny_pad, cap, nx_pad), WALK_ROWS, WALK_STRIDE,
                    threads, window, smem, items)


def walk_items(cnt, kmax: int, slots: int = WALK_SLOTS) -> list:
    """A tile's items as warp 0 lists them: (row, col, s, two) for the
    tile's cell counts ``cnt`` [rows][cols], in (row, slot step, column)
    order; s the first slot, ``two`` whether slot s + 1 is live too."""
    return [(r, c, s, slots == 2 and s + 1 < n[c])
            for r, n in enumerate(cnt) for s in range(0, kmax, slots)
            for c in range(len(n)) if s < n[c]]


# ---------------------------------------------------------------------------
# T1: K2's ref-based step, persistent, staging ahead
# ---------------------------------------------------------------------------

def forces_integrate_dbuf_torch(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                                params: FluidParams, cfg: IntegrateConfig,
                                grid: GridSpec2D, occ):
    """Plain PyTorch twin of T1: K2's ref-based function
    (``cuda_solver.forces_integrate_torch``).  Returns (xd', yd', vxd',
    vyd', disp2)."""
    return cuda_solver.forces_integrate_torch(xd, yd, vxd, vyd, rho_d,
                                              ref_xd, ref_yd, params, cfg,
                                              grid, occ)


def forces_integrate_dbuf_cuda(xd, yd, vxd, vyd, rho_d, ref_xd, ref_yd,
                               params: FluidParams, cfg: IntegrateConfig,
                               grid: GridSpec2D, occ):
    """K2's ref-based forces + integrate + bounce + displacement max as the
    persistent kernel T1 (``csrc/exp_dbuf.cu``); the contract of
    ``cuda_solver.forces_integrate_cuda``'s ref-based form (every lane in
    the max).  ``launches`` counts the launches."""
    planes = dict(xd=xd, yd=yd, vxd=vxd, vyd=vyd, rho_d=rho_d,
                  ref_xd=ref_xd, ref_yd=ref_yd)
    dev = _build.check_planes(grid, occ, **planes)
    _check_aligned(**planes)
    if dev.type == "cpu":
        return forces_integrate_dbuf_torch(xd, yd, vxd, vyd, rho_d, ref_xd,
                                           ref_yd, params, cfg, grid, occ)
    c = _forces_consts(params)
    outs = [torch.empty_like(xd) for _ in range(4)]
    disp = torch.empty(1, dtype=torch.float32, device=dev)
    _build.launch(
        "bgf_forces_integrate_dbuf", dev, xd.data_ptr(), yd.data_ptr(),
        vxd.data_ptr(), vyd.data_ptr(), rho_d.data_ptr(), ref_xd.data_ptr(),
        ref_yd.data_ptr(), occ.data_ptr(),
        *(o.data_ptr() for o in outs), disp.data_ptr(), grid.ny_pad,
        grid.cap, grid.nx_pad, grid.row_block, grid.n_row_blocks,
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k), float(cfg.dt),
        float(cfg.x_min), float(cfg.x_max), float(cfg.bounce),
        float(cfg.floor_y))
    forces_integrate_dbuf_cuda.launches += 1
    return (*outs, disp[0])


forces_integrate_dbuf_cuda.launches = 0


def dbuf_grid(cap: int) -> int:
    """The blocks T1 launches at slot capacity ``cap`` on the current
    device: its blocks per SM x SMs, once the card is found to hold them
    (fewer only on a grid of fewer tiles).  The blocks do not depend on the
    planes' other two dims."""
    out = (ctypes.c_int * 1)()
    rc = _build.load().bgf_forces_integrate_dbuf_grid(cap, out)
    if rc != 0:
        raise RuntimeError(f"bgf_forces_integrate_dbuf_grid: CUDA error {rc}")
    return int(out[0])


# ---------------------------------------------------------------------------
# T2: density on slot-major planes
# ---------------------------------------------------------------------------

def density_t_torch(xt, yt, params: FluidParams, grid: GridSpec2D,
                    occ) -> torch.Tensor:
    """Plain PyTorch twin of T2: K1's sum on slot-major planes, (kj, dx,
    dy) order; ghost blocks 0."""
    h2, coeff = _density_consts(params)
    kmax = _row_bound_t(occ, grid)
    rho = density_sum(xt, yt, h2, kmax,
                      lambda kj: _taps_t((xt, yt), kj, "dxdy"),
                      int(kmax.max()))
    return rho * float(coeff)


def density_t_cuda(xt, yt, params: FluidParams, grid: GridSpec2D,
                   occ) -> torch.Tensor:
    """Density over slot-major planes ``[cap, ny_pad, nx_pad]`` (kernel
    T2), each 16-byte aligned; ``occ`` is ``block_kmax3_t(xt, grid)``.
    Returns a new slot-major rho plane with ghost blocks 0.  On the card
    ``walk_plan`` refuses a cap past ``WALK_MAX_CAP``.  ``launches`` counts
    the launches."""
    dev = _build.check_planes(grid, occ, shape=slot_major_shape(grid),
                              xt=xt, yt=yt)
    _check_aligned(xt=xt, yt=yt)
    if dev.type == "cpu":
        return density_t_torch(xt, yt, params, grid, occ)
    walk_plan(grid.plane_shape, "density_t")
    h2, coeff = _density_consts(params)
    rho = torch.empty_like(xt)
    _build.launch("bgf_density_t", dev, xt.data_ptr(), yt.data_ptr(),
                  occ.data_ptr(), rho.data_ptr(), grid.ny_pad, grid.cap,
                  grid.nx_pad, grid.row_block, grid.n_row_blocks, float(h2),
                  float(coeff))
    density_t_cuda.launches += 1
    return rho


density_t_cuda.launches = 0


# ---------------------------------------------------------------------------
# T3: forces on slot-major planes
# ---------------------------------------------------------------------------

def forces_t_torch(xt, yt, vxt, vyt, rhot, params: FluidParams,
                   grid: GridSpec2D, occ):
    """Plain PyTorch twin of T3: K8's pair sum on slot-major planes, taps
    in (kj, dy, dx) order.  Returns (ax_t, ay_t); ghost blocks 0."""
    p, ir = _eos(rhot, params)
    kmax = _row_bound_t(occ, grid)
    return _force_sum(xt, yt, vxt, vyt, p, params, kmax,
                      lambda kj: _taps_t((xt, yt, vxt, vyt, p, ir), kj,
                                         "dydx"),
                      int(kmax.max()))


def forces_t_cuda(xt, yt, vxt, vyt, rhot, params: FluidParams,
                  grid: GridSpec2D, occ):
    """Pressure + viscosity accelerations over slot-major planes (kernel
    T3); ``occ`` is ``block_kmax3_t(xt, grid)``.  Returns new slot-major
    (ax_t, ay_t), dead slots and ghost blocks +0.  ``launches`` counts the
    launches."""
    planes = dict(xt=xt, yt=yt, vxt=vxt, vyt=vyt, rhot=rhot)
    dev = _build.check_planes(grid, occ, shape=slot_major_shape(grid),
                              **planes)
    _check_aligned(**planes)
    if dev.type == "cpu":
        return forces_t_torch(xt, yt, vxt, vyt, rhot, params, grid, occ)
    c = _forces_consts(params)
    ax = torch.empty_like(xt)
    ay = torch.empty_like(xt)
    _build.launch(
        "bgf_forces_t", dev, xt.data_ptr(), yt.data_ptr(), vxt.data_ptr(),
        vyt.data_ptr(), rhot.data_ptr(), occ.data_ptr(), ax.data_ptr(),
        ay.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks,
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(params.rho_0), float(params.k))
    forces_t_cuda.launches += 1
    return ax, ay


forces_t_cuda.launches = 0


# ---------------------------------------------------------------------------
# T4: the forces arithmetic variants
# ---------------------------------------------------------------------------

def _variant_sum(xi, yi, vxi, vyi, p_i, params: FluidParams, bound, tap_fn,
                 n_kj: int, variant: str):
    """(ax, ay) of variant v0nr, v1, v2 or v3 in (kj, dx, dy) order over kj
    < bound (v3: the bound rounded up to even; a slot past the plane's last
    is FAR there and is skipped, which adds the same exact 0)."""
    c = _forces_consts(params)
    h, m_half, spiky_c, visc_mc = (float(c[k]) for k in
                                   ("h", "m_half", "spiky_c", "visc_mc"))
    c1 = float(c["m_half"] * c["spiky_c"])   # (-m/2) spiky_c in float32
    if variant == "v3":
        bound = (bound + 1) // 2 * 2
        n_kj = (n_kj + 1) // 2 * 2
    ax = torch.zeros_like(xi)
    ay = torch.zeros_like(xi)
    sv = torch.zeros_like(xi)
    for kj in range(min(n_kj, xi.shape[1])):
        on = kj < bound
        for rx, ry, rvx, rvy, rp, ri in tap_fn(kj):
            ddx = xi - rx
            ddy = yi - ry
            r2 = ddx * ddx + ddy * ddy
            if variant == "v0nr":
                inv_r = r2 + float(EPS_NR)
                hr = torch.clamp_min(h - r2 * inv_r, 0.0)
                fac_p = m_half * (p_i + rp) * ri * (spiky_c * hr * hr * inv_r)
                fac_v = visc_mc * ri * hr
                dax = fac_p * ddx + fac_v * (rvx - vxi)
                day = fac_p * ddy + fac_v * (rvy - vyi)
            else:
                inv_r = torch.rsqrt(r2 + float(EPS2))
                hr = torch.clamp_min(h - r2 * inv_r, 0.0)
                u = (p_i + rp) * ri
                fac_p = (c1 * u) * (hr * hr * inv_r)
                fac_v = (visc_mc * hr) * ri
                if variant == "v1":
                    dax = fac_p * ddx + fac_v * (rvx - vxi)
                    day = fac_p * ddy + fac_v * (rvy - vyi)
                else:
                    dax = fac_p * ddx + fac_v * rvx
                    day = fac_p * ddy + fac_v * rvy
                    sv = torch.where(on, sv + fac_v, sv)
            ax = torch.where(on, ax + dax, ax)
            ay = torch.where(on, ay + day, ay)
    if variant in ("v2", "v3"):
        ax = ax - vxi * sv
        ay = ay - vyi * sv
    return ax, ay


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")


def forces_variant_torch(xd, yd, vxd, vyd, rho_d, params: FluidParams,
                         grid: GridSpec2D, occ, variant: str):
    """Plain PyTorch twin of T4's ``variant``: v0 is K8's twin
    (``cuda_solver.forces_torch``), the others their TPU variant's float
    operations in order.  Returns (ax_d, ay_d); ghost blocks 0."""
    _check_variant(variant)
    if variant == "v0":
        return cuda_solver.forces_torch(xd, yd, vxd, vyd, rho_d, params,
                                        grid, occ)
    p, ir = _eos(rho_d, params)
    kmax = row_kmax(occ, grid)
    return _variant_sum(xd, yd, vxd, vyd, p, params, kmax,
                        lambda kj: taps((xd, yd, vxd, vyd, p, ir), kj),
                        int(kmax.max()), variant)


def forces_variant_cuda(xd, yd, vxd, vyd, rho_d, params: FluidParams,
                        grid: GridSpec2D, occ, variant: str):
    """K8's accelerations in arithmetic variant ``variant`` (kernel T4, one
    of ``VARIANTS``); K8's contract, the planes 16-byte aligned.  On the
    card ``walk_plan`` refuses a cap past ``WALK_MAX_CAP``.  ``launches``
    counts every launch, ``launches_<variant>`` each variant's."""
    _check_variant(variant)
    planes = dict(xd=xd, yd=yd, vxd=vxd, vyd=vyd, rho_d=rho_d)
    dev = _build.check_planes(grid, occ, **planes)
    _check_aligned(**planes)
    if dev.type == "cpu":
        return forces_variant_torch(xd, yd, vxd, vyd, rho_d, params, grid,
                                    occ, variant)
    walk_plan(grid.plane_shape, "forces_variant")
    c = _forces_consts(params)
    ax = torch.empty_like(xd)
    ay = torch.empty_like(xd)
    _build.launch(
        "bgf_forces_variant", dev, xd.data_ptr(), yd.data_ptr(),
        vxd.data_ptr(), vyd.data_ptr(), rho_d.data_ptr(), occ.data_ptr(),
        ax.data_ptr(), ay.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad,
        grid.row_block, grid.n_row_blocks, VARIANTS.index(variant),
        *(float(c[k]) for k in ("h", "m_half", "spiky_c", "visc_mc")),
        float(c["m_half"] * c["spiky_c"]), float(params.rho_0),
        float(params.k))
    forces_variant_cuda.launches += 1
    name = f"launches_{variant}"
    setattr(forces_variant_cuda, name,
            getattr(forces_variant_cuda, name) + 1)
    return ax, ay


forces_variant_cuda.launches = 0
for _v in VARIANTS:
    setattr(forces_variant_cuda, f"launches_{_v}", 0)
del _v
