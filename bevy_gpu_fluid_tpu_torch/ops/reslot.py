"""Dense local rebinning ("reslot"): sort-free Verlet rebuilds (port of
``bevy_gpu_fluid_tpu/ops/reslot.py``, single-chip posture).

Between deferred rebins the Verlet skin bounds every live particle's
displacement to less than one cell, so at rebin time its true cell is
within +-1 of the cell of the slot it occupies.  The rebin is therefore
local: each cell re-collects its occupants from its 3x3 slot
neighbourhood, in (kj, dx, dy) candidate order, and compacts them into its
``cap`` slots.  Matches beyond ``cap`` are dropped and show in the returned
per-cell counts.  Particle identity rides along in the int32 ``idx_d``
plane (-1 = empty).

``reslot_cuda`` is the wrapper of kernel K3 (``csrc/reslot.cu``), which
replaces the TPU kernel ``_reslot_kernel`` (reslot.py:203).
``reslot_torch`` is its plain PyTorch twin, written in the form of the
reference's ``reslot_xla``; the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import GridSpec2D
from ..kernels import _build
from .binning import FAR, cell_index, inv_cell


def _occ_row(xd: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """Max occupied slot index + 1 per cell row, int32 [ny_pad], read off
    the FAR sentinel."""
    k1 = torch.arange(1, grid.cap + 1, dtype=torch.int32,
                      device=xd.device)[None, :, None]
    return torch.where(xd < FAR * 0.5, k1, 0).amax(dim=(1, 2))


def block_kmax3(xd: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """Per-row-block, per-row-shift slot-loop bounds int32 [3, n_row_blocks]:
    ``out[1 + dy, r]`` bounds the occupied slots of the tb-row window
    [(r+1)*tb + dy, (r+1)*tb + dy + tb) that row block r reads at row shift
    dy.  The stencil kernels bound their kj loops with it."""
    occ_row = _occ_row(xd, grid)
    tb, nb = grid.row_block, grid.n_row_blocks
    pad = torch.cat([occ_row, occ_row.new_zeros(tb)])
    wmax = pad.unfold(0, tb, 1).amax(dim=1)        # wmax[s] = max(row[s:s+tb])
    starts = (torch.arange(nb, device=xd.device) + 1) * tb
    return torch.stack([wmax[starts - 1], wmax[starts],
                        wmax[starts + 1]]).contiguous()


def _cell_of(x: torch.Tensor, y: torch.Tensor, grid: GridSpec2D, live):
    """Clipped cell coords of candidate positions, -9 for dead slots (the
    clip alone would resurrect FAR into the boundary cells)."""
    inv = inv_cell(grid)
    cx = cell_index(x, grid.origin_x, inv, 0, grid.nx - 1)
    cy = cell_index(y, grid.origin_y, inv, 0, grid.ny - 1)
    return torch.where(live, cx, -9), torch.where(live, cy, -9)


def taps(planes, kj: int):
    """Neighbour views of slot ``kj`` in candidate order (dx, then dy):
    yields lists with ``view[i][row, 0, col] = planes[i][row + dy, kj,
    (col + dx) mod nx_pad]`` — the TPU kernels' row shift and lane roll,
    both wrapping (the wrapped taps land on empty ghost rows and columns).
    Looping ``kj`` outside gives the (kj, dx, dy) order of every stencil
    kernel here."""
    slot = [p[:, kj:kj + 1, :] for p in planes]
    for dx in (-1, 0, 1):
        rolled = [torch.roll(s, -dx, 2) for s in slot]
        for dy in (-1, 0, 1):
            yield [torch.roll(r, -dy, 0) for r in rolled]


def reslot_torch(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D):
    """Plain PyTorch twin of kernel K3 (the reference's ``reslot_xla``):
    rolled views, one-hot select per candidate.  Returns (xd, yd, vxd, vyd,
    idx_d, counts) with counts int32 [ny_pad, nx_pad]."""
    cap = grid.cap
    shape = xd.shape
    dev = xd.device
    tgt_cx = (torch.arange(shape[2], device=dev) - 1)[None, None, :]
    tgt_cy = (torch.arange(shape[0], device=dev) - grid.row0)[:, None, None]
    kiota = torch.arange(cap, device=dev)[None, :, None]
    ccx, ccy = _cell_of(xd, yd, grid, xd < FAR * 0.5)

    out_x = torch.full(shape, FAR, dtype=torch.float32, device=dev)
    out_y = torch.full(shape, FAR, dtype=torch.float32, device=dev)
    out_vx = torch.zeros(shape, dtype=torch.float32, device=dev)
    out_vy = torch.zeros(shape, dtype=torch.float32, device=dev)
    out_i = torch.full(shape, -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((shape[0], 1, shape[2]), dtype=torch.int64, device=dev)

    for kj in range(cap):
        for cx, cy, x, y, vx, vy, i in taps(
                (ccx, ccy, xd, yd, vxd, vyd, idx_d), kj):
            match = (cx == tgt_cx) & (cy == tgt_cy)
            sel = match & (cnt == kiota)              # one-hot over slots
            out_x = torch.where(sel, x, out_x)
            out_y = torch.where(sel, y, out_y)
            out_vx = torch.where(sel, vx, out_vx)
            out_vy = torch.where(sel, vy, out_vy)
            out_i = torch.where(sel, i, out_i)
            cnt = cnt + match
    return out_x, out_y, out_vx, out_vy, out_i, cnt[:, 0, :].to(torch.int32)


def reslot_cuda(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D):
    """Dense local rebin; same contract as ``reslot_torch``.  CUDA tensors
    launch kernel K3 (``csrc/reslot.cu``); CPU tensors take the twin.  The
    slot-loop bounds are recomputed from the input planes."""
    dev = _build.check_planes(grid, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              idx_d=idx_d)
    if dev.type == "cpu":
        return reslot_torch(xd, yd, vxd, vyd, idx_d, grid)
    occ = block_kmax3(xd, grid)
    outs = [torch.empty_like(xd) for _ in range(4)] + [torch.empty_like(idx_d)]
    cnt = torch.empty((grid.ny_pad, grid.nx_pad), dtype=torch.int32,
                      device=dev)
    _build.launch(
        "bgf_reslot", dev, xd.data_ptr(), yd.data_ptr(), vxd.data_ptr(),
        vyd.data_ptr(), idx_d.data_ptr(), occ.data_ptr(),
        *(o.data_ptr() for o in outs), cnt.data_ptr(),
        grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks, grid.row0, grid.nx, grid.ny,
        float(np.float32(grid.origin_x)), float(np.float32(grid.origin_y)),
        float(inv_cell(grid)))
    reslot_cuda.launches += 1
    return (*outs, cnt)


reslot_cuda.launches = 0


def make_reslot(grid: GridSpec2D):
    """Returns reslot(xd, yd, vxd, vyd, idx_d) -> (xd, yd, vxd, vyd, idx_d,
    counts) on this grid."""
    def fn(xd, yd, vxd, vyd, idx_d):
        return reslot_cuda(xd, yd, vxd, vyd, idx_d, grid)
    return fn
