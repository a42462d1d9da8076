"""Dense local rebinning ("reslot"): sort-free Verlet rebuilds (port of
``bevy_gpu_fluid_tpu/ops/reslot.py``).

Between deferred rebins the Verlet skin bounds every live particle's
displacement to less than one cell, so at rebin time its true cell is
within +-1 of the cell of the slot it occupies.  The rebin is therefore
local: each cell re-collects its occupants from its 3x3 slot
neighbourhood, in (kj, dx, dy) candidate order, and compacts them into its
``cap`` slots.  Matches beyond ``cap`` are dropped and show in the returned
per-cell counts.  Particle identity rides along in the int32 ``idx_d``
plane (-1 = empty).

A candidate's cell is ``floor((p - origin) / cell_size)``, its x clipped to
[clip_lo, clip_hi] and its y to [0, ny-1].  The single-chip rebin takes the
grid's origin and [0, nx-1]; a slab of the sharded solver passes its own
origin and [-1, nx], so a particle that left the slab lands in the ghost
column on its exit side (``parallel/shard_verlet.py`` moves it to the
neighbour).  K3's and K6's wrappers and twins and ``reslot_planar`` take
``clip_lo``, ``clip_hi`` and ``origin``, and the kernels take them as data.

``reslot_cuda`` is the wrapper of kernel K3 (``csrc/reslot.cu``), which
replaces the TPU kernel ``_reslot_kernel`` (reslot.py:203).
``reslot_torch`` is its plain PyTorch twin, written in the form of the
reference's ``reslot_xla``; the two agree bit for bit.

The PLANAR rebin (``reslot_planar``, the reference's reslot.py:346-644)
splits the same rebin in two phases so that it never holds all five input
and five output planes at once:

1. SELECT, kernel K6 (``select_cuda``, ``csrc/select.cu``; replaces
   ``_select_kernel``, reslot.py:393): K3's candidate scan over x/y alone,
   writing a routing CODE per target slot, ``kj*9 + (dx+1)*3 + (dy+1)``
   for the candidate (kj, dx, dy) that lands there, -1 for an empty slot,
   plus the per-cell match counts.  The code plane is int32 or int8
   (``code_dtype``, an argument here where the reference reads an
   environment variable).
2. APPLY, kernel K7 (``apply_code_cuda``, ``csrc/apply_code.cu``; replaces
   ``_apply_kernel``, reslot.py:504), once per payload plane: the plane
   routed through the code.  ``apply_planes`` runs the five applies and
   drops each input plane after its apply, so one input and one output
   are alive at a time.

The slot assignment is K3's bit for bit (the two kernels share one scan,
``bgf::scan_candidates``).  ``taken_mask`` reads the drops of a rebin off
the code plane alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import GridSpec2D
from ..kernels import _build
from .binning import FAR, cell_index, inv_cell


def _occ_row(xd: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """Max occupied slot index + 1 per cell row, int32 [ny_pad], read off
    the FAR sentinel, in row slabs (``slab_rows``): in one pass its int32
    temporary is a whole plane, at the memory ceiling a plane-footprint
    beside every rebin's planes."""
    k1 = torch.arange(1, grid.cap + 1, dtype=torch.int32,
                      device=xd.device)[None, :, None]
    rows = slab_rows(xd.shape)
    parts = [torch.where(xd[r:r + rows] < FAR * 0.5, k1, 0).amax(dim=(1, 2))
             for r in range(0, xd.shape[0], rows)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


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


def row_kmax(occ: torch.Tensor, grid: GridSpec2D) -> torch.Tensor:
    """Slot-loop bound per row, int64 [ny_pad, 1, 1]: the row block's max
    over the three row shifts of ``occ``, 0 on the ghost blocks (which the
    kernels never compute)."""
    tb = grid.row_block
    km = torch.zeros(grid.ny_pad, dtype=torch.int64, device=occ.device)
    km[tb:tb + grid.n_row_blocks * tb] = \
        occ.amax(dim=0).to(torch.int64).repeat_interleave(tb)
    return km[:, None, None]


def cell_args(grid: GridSpec2D, clip_lo: int = 0, clip_hi: int | None = None,
              origin=None):
    """(clip_lo, clip_hi, origin_x, origin_y) of a rebin, the origin as
    float32 values: the grid's own by default, its x clip [0, nx-1].
    Raises ValueError for a clip outside [-1, nx], whose cells would fall
    off the ghost columns."""
    clip_hi = grid.nx - 1 if clip_hi is None else clip_hi
    if not -1 <= clip_lo <= clip_hi <= grid.nx:
        raise ValueError(f"clip [{clip_lo}, {clip_hi}] outside [-1, "
                         f"{grid.nx}]")
    ox, oy = (grid.origin_x, grid.origin_y) if origin is None else origin
    return clip_lo, clip_hi, np.float32(ox), np.float32(oy)


def _cell_of(x: torch.Tensor, y: torch.Tensor, grid: GridSpec2D, live,
             cells=None):
    """Clipped cell coords of candidate positions (``cells`` from
    ``cell_args``, the single-chip clip and origin by default), -9 for dead
    slots (the clip alone would resurrect FAR into the boundary cells)."""
    clip_lo, clip_hi, ox, oy = cells or cell_args(grid)
    inv = inv_cell(grid)
    cx = cell_index(x, ox, inv, clip_lo, clip_hi)
    cy = cell_index(y, oy, inv, 0, grid.ny - 1)
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


def _targets(grid: GridSpec2D, device):
    """Target cell coords per dense position (lane l -> cx = l - 1, row r
    -> cy = r - row0; ghosts get unreachable values) and the slot iota."""
    tgt_cx = (torch.arange(grid.nx_pad, device=device) - 1)[None, None, :]
    tgt_cy = (torch.arange(grid.ny_pad, device=device)
              - grid.row0)[:, None, None]
    kiota = torch.arange(grid.cap, device=device)[None, :, None]
    return tgt_cx, tgt_cy, kiota


def reslot_torch(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D,
                 clip_lo: int = 0, clip_hi: int | None = None, origin=None):
    """Plain PyTorch twin of kernel K3 (the reference's ``reslot_xla``):
    rolled views, one-hot select per candidate.  Returns (xd, yd, vxd, vyd,
    idx_d, counts) with counts int32 [ny_pad, nx_pad]."""
    cap = grid.cap
    shape = xd.shape
    dev = xd.device
    tgt_cx, tgt_cy, kiota = _targets(grid, dev)
    ccx, ccy = _cell_of(xd, yd, grid, xd < FAR * 0.5,
                        cell_args(grid, clip_lo, clip_hi, origin))

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


def reslot_cuda(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D,
                clip_lo: int = 0, clip_hi: int | None = None, origin=None):
    """Dense local rebin; same contract as ``reslot_torch``.  CUDA tensors
    launch kernel K3 (``csrc/reslot.cu``); CPU tensors take the twin.  The
    slot-loop bounds are recomputed from the input planes.  ``launches``
    counts every launch, ``launches_clip`` those given a clip or an
    origin (a slab's rebin)."""
    custom = (clip_lo, clip_hi, origin) != (0, None, None)
    dev = _build.check_planes(grid, xd=xd, yd=yd, vxd=vxd, vyd=vyd,
                              idx_d=idx_d)
    clip_lo, clip_hi, ox, oy = cell_args(grid, clip_lo, clip_hi, origin)
    if dev.type == "cpu":
        return reslot_torch(xd, yd, vxd, vyd, idx_d, grid, clip_lo, clip_hi,
                            (ox, oy))
    occ = block_kmax3(xd, grid)
    outs = [torch.empty_like(xd) for _ in range(4)] + [torch.empty_like(idx_d)]
    cnt = torch.empty((grid.ny_pad, grid.nx_pad), dtype=torch.int32,
                      device=dev)
    _build.launch(
        "bgf_reslot", dev, xd.data_ptr(), yd.data_ptr(), vxd.data_ptr(),
        vyd.data_ptr(), idx_d.data_ptr(), occ.data_ptr(),
        *(o.data_ptr() for o in outs), cnt.data_ptr(),
        grid.ny_pad, grid.cap, grid.nx_pad, grid.row_block,
        grid.n_row_blocks, grid.row0, clip_lo, clip_hi, grid.ny, float(ox),
        float(oy), float(inv_cell(grid)))
    reslot_cuda.launches += 1
    reslot_cuda.launches_clip += int(custom)
    return (*outs, cnt)


reslot_cuda.launches = 0
reslot_cuda.launches_clip = 0


def make_reslot(grid: GridSpec2D):
    """Returns reslot(xd, yd, vxd, vyd, idx_d) -> (xd, yd, vxd, vyd, idx_d,
    counts) on this grid."""
    def fn(xd, yd, vxd, vyd, idx_d):
        return reslot_cuda(xd, yd, vxd, vyd, idx_d, grid)
    return fn


# ---------------------------------------------------------------------------
# The planar rebin: K6 (select), K7 (apply), taken_mask, reslot_planar
# ---------------------------------------------------------------------------

CODE_DTYPES = (torch.int32, torch.int8)
_CODE_EMPTY = -1
# Empty-slot values of the five payload planes (x, y, vx, vy, idx).
PLANE_FILLS = (FAR, FAR, 0.0, 0.0, -1)


def code_of(kj: int, dx: int, dy: int) -> int:
    """Routing code of candidate (kj, dx, dy), in candidate order."""
    return kj * 9 + (dx + 1) * 3 + (dy + 1)


def check_code_dtype(code_dtype, cap: int) -> None:
    """Raise ValueError unless ``code_dtype`` holds every code of a grid
    with ``cap`` slots per cell (codes reach 9 * cap - 1: int8 takes cap
    <= 14)."""
    if code_dtype not in CODE_DTYPES:
        raise ValueError(f"code_dtype must be torch.int32 or torch.int8, "
                         f"got {code_dtype}")
    top = code_of(cap - 1, 1, 1)
    if top > torch.iinfo(code_dtype).max:
        raise ValueError(f"code_dtype {code_dtype} cannot hold code {top} "
                         f"of cap {cap}; use torch.int32")


def select_torch(xd, yd, grid: GridSpec2D, occ=None,
                 code_dtype=torch.int32, clip_lo: int = 0,
                 clip_hi: int | None = None, origin=None):
    """Plain PyTorch twin of kernel K6, in ``reslot_torch``'s form, with
    the kernel's per-row-block slot bound from ``occ`` (the planes'
    ``block_kmax3``, computed when not given).  Returns (code, counts):
    code ``code_dtype`` [ny_pad, cap, nx_pad] (-1 = empty, ghost blocks
    -1), counts int32 [ny_pad, nx_pad]."""
    check_code_dtype(code_dtype, grid.cap)
    if occ is None:
        occ = block_kmax3(xd, grid)
    tgt_cx, tgt_cy, kiota = _targets(grid, xd.device)
    kmax = row_kmax(occ, grid)
    ccx, ccy = _cell_of(xd, yd, grid, xd < FAR * 0.5,
                        cell_args(grid, clip_lo, clip_hi, origin))
    code = torch.full(xd.shape, _CODE_EMPTY, dtype=torch.int32,
                      device=xd.device)
    cnt = torch.zeros((xd.shape[0], 1, xd.shape[2]), dtype=torch.int64,
                      device=xd.device)
    for kj in range(int(kmax.max())):
        views = taps((ccx, ccy), kj)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cx, cy = next(views)
                match = (cx == tgt_cx) & (cy == tgt_cy) & (kj < kmax)
                code = torch.where(match & (cnt == kiota),
                                   code_of(kj, dx, dy), code)
                cnt = cnt + match
    return code.to(code_dtype), cnt[:, 0, :].to(torch.int32)


def select_cuda(xd, yd, grid: GridSpec2D, occ=None,
                code_dtype=torch.int32, clip_lo: int = 0,
                clip_hi: int | None = None, origin=None):
    """The planar rebin's routing pass; same contract as ``select_torch``.
    CUDA tensors launch kernel K6 (``csrc/select.cu``); CPU tensors take
    the twin.  ``occ`` (the planes' ``block_kmax3``) is computed when not
    given.  ``launches`` counts every launch, ``launches_clip`` those given
    a clip or an origin."""
    check_code_dtype(code_dtype, grid.cap)
    custom = (clip_lo, clip_hi, origin) != (0, None, None)
    if occ is None:
        occ = block_kmax3(xd, grid)
    dev = _build.check_planes(grid, occ, xd=xd, yd=yd)
    clip_lo, clip_hi, ox, oy = cell_args(grid, clip_lo, clip_hi, origin)
    if dev.type == "cpu":
        return select_torch(xd, yd, grid, occ, code_dtype, clip_lo, clip_hi,
                            (ox, oy))
    code = torch.empty(grid.plane_shape, dtype=code_dtype, device=dev)
    cnt = torch.empty((grid.ny_pad, grid.nx_pad), dtype=torch.int32,
                      device=dev)
    _build.launch(
        "bgf_select", dev, xd.data_ptr(), yd.data_ptr(), occ.data_ptr(),
        code.data_ptr(), cnt.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad,
        grid.row_block, grid.n_row_blocks, grid.row0, clip_lo, clip_hi,
        grid.ny, code.element_size(), float(ox), float(oy),
        float(inv_cell(grid)))
    select_cuda.launches += 1
    select_cuda.launches_clip += int(custom)
    return code, cnt


select_cuda.launches = 0
select_cuda.launches_clip = 0


def _decode(code: torch.Tensor):
    """(c, kj, dx, dy) int64 planes of a code plane (meaningless where
    c < 0)."""
    c = code.to(torch.int64)
    kj = torch.div(c, 9, rounding_mode="floor")
    r = c - kj * 9
    dx = torch.div(r, 3, rounding_mode="floor") - 1
    return c, kj, dx, r - (dx + 1) * 3 - 1


def _check_out(out, payload) -> None:
    """Refuse an ``out`` plane K7 cannot write: another shape, dtype or
    device than the payload's, not contiguous, or overlapping the payload
    (the kernel reads a +-1-row halo of its payload, so a write over it
    would corrupt rows still to be read)."""
    if (out.shape != payload.shape or out.dtype != payload.dtype
            or out.device != payload.device or not out.is_contiguous()):
        raise ValueError(
            f"out: want a contiguous {payload.dtype} {tuple(payload.shape)} "
            f"plane on {payload.device}, got {out.dtype} {tuple(out.shape)} "
            f"on {out.device}")
    size = payload.numel() * payload.element_size()
    if (out.data_ptr() < payload.data_ptr() + size
            and payload.data_ptr() < out.data_ptr() + size):
        raise ValueError("out overlaps the payload: K7 reads a +-1-row "
                         "halo of its payload and never writes over it")


def apply_code_torch(payload, code, occ, grid: GridSpec2D, fill, out=None):
    """Plain PyTorch twin of kernel K7: each output slot of an interior row
    whose code names source slot (row + dy, kj, col + dx) (columns wrap
    modulo nx_pad) with kj below its row block's bound in ``occ`` takes the
    payload there; every other slot, and the ghost blocks, ``fill``.
    Written into ``out`` when given (see ``apply_code_cuda``)."""
    if out is not None:
        _check_out(out, payload)
        return out.copy_(apply_code_torch(payload, code, occ, grid, fill))
    R, cap, C = payload.shape
    dev = payload.device
    c, kj, dx, dy = _decode(code)
    ok = (c >= 0) & (kj < row_kmax(occ, grid))
    rows = torch.arange(R, device=dev)[:, None, None]
    cols = torch.arange(C, device=dev)[None, None, :]
    vals = payload[torch.clamp(rows + dy, 0, R - 1),
                   torch.clamp(kj, 0, cap - 1),
                   torch.remainder(cols + dx, C)]
    return torch.where(ok, vals, fill)


def apply_code_cuda(payload, code, occ, grid: GridSpec2D, fill, out=None):
    """Route one payload plane (float32 or int32) through a code plane
    (int32 or int8); same contract as ``apply_code_torch``.  ``occ`` is the
    PRE-rebin ``block_kmax3``, the one the code was selected under.

    Returns a new plane, or writes into ``out`` (the reference's ``out``: a
    DEAD plane of the payload's shape, dtype and device, never read) and
    returns it.  The kernel reads a +-1-row halo of its payload, so ``out``
    may not overlap the payload (ValueError).  ``apply_planes`` and the
    Session's planar rebin keep fresh outputs: the reference writes into
    dead planes to chain around XLA's donation pairing (its donor chain),
    which the port does not need, and no measured posture's rebin peaks
    above its step (``verlet_solver.FOOTPRINTS``; the sharded ceiling's
    rebin 7.246 slab-plane-footprints under its step's 8.000).
    ``launches`` counts every launch, ``launches_out`` those into ``out``."""
    dev = _build.check_planes(grid, occ,
                              dtypes={"payload": (torch.float32, torch.int32),
                                      "code": CODE_DTYPES},
                              payload=payload, code=code)
    if dev.type == "cpu":
        return apply_code_torch(payload, code, occ, grid, fill, out)
    if out is not None:
        _check_out(out, payload)
    bits = np.array(fill, dtype=np.float32 if payload.is_floating_point()
                    else np.int32).view(np.int32)
    dst = torch.empty_like(payload) if out is None else out
    _build.launch(
        "bgf_apply_code", dev, payload.data_ptr(), code.data_ptr(),
        occ.data_ptr(), dst.data_ptr(), grid.ny_pad, grid.cap, grid.nx_pad,
        grid.row_block, grid.n_row_blocks, code.element_size(), int(bits))
    apply_code_cuda.launches += 1
    apply_code_cuda.launches_out += int(out is not None)
    return dst


apply_code_cuda.launches = 0
apply_code_cuda.launches_out = 0


# Whole-plane torch passes with many temporaries (``taken_mask`` and
# ``block_kmax3`` here, ``cuda_solver.integrate_into``, the rebin's count
# of live slots, ``verlet_solver.live_slots``) run in SLABS row slabs on
# planes of more than SLAB_MIN elements, so their temporaries are a fixed
# share of a plane at every size, and in one pass on smaller planes (no
# extra launches at 1M).
SLABS = 16
SLAB_MIN = 1 << 24


def slab_rows(shape) -> int:
    """Rows per slab of a [rows, cap, cols] plane (see ``SLABS``)."""
    rows = shape[0]
    if rows * shape[1] * shape[2] <= SLAB_MIN:
        return rows
    return -(-rows // SLABS)


def taken_mask(code: torch.Tensor, cap: int) -> torch.Tensor:
    """Per SOURCE slot, bool [ny_pad, cap, nx_pad]: did some target slot's
    code route it?  The planar rebin's drop test, read off the code plane
    alone, so the pre-rebin payload planes need not stay alive for it.  A
    code whose source lies outside the plane marks nothing (the
    reference's halo pad; select never writes such a code).  Decoded in
    row slabs (``slab_rows``): its int64 temporaries would be about ten
    plane-footprints in one pass."""
    R, _, C = code.shape
    dev = code.device
    taken = torch.zeros(code.numel(), dtype=torch.bool, device=dev)
    rows = slab_rows(code.shape)
    for r0 in range(0, R, rows):
        c, kj, dx, dy = _decode(code[r0:r0 + rows])
        sr = torch.arange(r0, r0 + c.shape[0], device=dev)[:, None, None] + dy
        sc = torch.arange(C, device=dev)[None, None, :] + dx
        ok = (c >= 0) & (sr >= 0) & (sr < R) & (sc >= 0) & (sc < C)
        taken[((sr * cap + kj) * C + sc)[ok]] = True
    return taken.view(code.shape)


def apply_planes(planes: list, code, occ, grid: GridSpec2D) -> list:
    """The planar rebin's second phase: the five payload planes (x, y, vx,
    vy, idx) routed through ``code``, one K7 each, as a new list.  TAKES
    ``planes``: each entry is set to None once its copy exists, so a caller
    that keeps no other reference frees each input plane after its apply
    and holds one input and one output beyond the code at a time.  All five
    are checked before the first apply, which leaves the list whole when a
    plane is refused."""
    for plane in planes:
        _build.check_planes(grid, occ,
                            dtypes={"payload": (torch.float32, torch.int32),
                                    "code": CODE_DTYPES},
                            payload=plane, code=code)
    out = []
    for i, fill in enumerate(PLANE_FILLS):
        out.append(apply_code_cuda(planes[i], code, occ, grid, fill))
        planes[i] = None
    return out


def reslot_planar(xd, yd, vxd, vyd, idx_d, grid: GridSpec2D,
                  code_dtype=torch.int32, clip_lo: int = 0,
                  clip_hi: int | None = None, origin=None):
    """Plane-at-a-time dense local rebin (K6, then ``apply_planes``): the
    same contract, and the same outputs bit for bit, as ``reslot_cuda``."""
    occ = block_kmax3(xd, grid)
    code, cnt = select_cuda(xd, yd, grid, occ, code_dtype, clip_lo, clip_hi,
                            origin)
    return (*apply_planes([xd, yd, vxd, vyd, idx_d], code, occ, grid), cnt)
