"""Sort-based spatial-hash binning (port of
``bevy_gpu_fluid_tpu/ops/binning.py``, the ``with_csr=False`` path).

A stable argsort orders particles by cell id, a particle's within-cell rank
is its sorted position less its cell's first sorted position (a binary
search of the sorted ids for their own values), and one scatter returns the
ranks to original particle order — so within-cell order is original-index
order, bit for bit the reference package's slot assignment.

Dense layout ``[ny_pad, cap, nx_pad]`` with the reference's ghost border;
empty position slots hold the ``FAR`` sentinel so every pair test against
them fails the r^2 < h^2 gate.  Particles ranked beyond ``cap`` overflow:
they get no slot and are counted.

A binning addresses the dense planes by one flat slot index a particle,
computed once and shared by every scatter and gather, so neither takes a
boolean mask (a mask index is a ``nonzero``: a host sync on the card).  A
dropped particle's index is 0, lane 0 of row 0: a ghost slot of every
plane, which always holds the plane's fill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import GridSpec2D
from ..utils.profiling import span

FAR = 1.0e9  # empty-slot sentinel for position fields


@dataclasses.dataclass
class Binned:
    """Result of binning N particles (original order): clamped cell coords
    ``cx``/``cy`` and within-cell ``rank`` (int64[N]), plus ``overflow``,
    the host count of particles ranked at or beyond ``cap``; ``perm``
    (int64[N], ``bin_particles`` only) is the sort's order, the original
    index of the i-th particle by cell.  ``keep`` (``rank < cap``) and
    ``slot`` (``slot_index``) are derived once, at construction."""

    cx: torch.Tensor
    cy: torch.Tensor
    rank: torch.Tensor
    overflow: int
    grid: GridSpec2D
    perm: torch.Tensor | None = None
    keep: torch.Tensor = dataclasses.field(init=False)
    slot: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        self.keep = self.rank < self.grid.cap
        self.slot = slot_index(self.grid, self.cx, self.cy, self.rank,
                               self.keep)


def slot_index(grid: GridSpec2D, cx, cy, rank, keep) -> torch.Tensor:
    """Flat index into a contiguous [ny_pad, cap, nx_pad] plane of each
    particle's slot (row ``cy + row0``, slot ``rank``, lane ``cx + 1``);
    0 (lane 0 of row 0, a ghost slot) where ``keep`` is False."""
    flat = ((cy + grid.row0) * grid.cap + rank) * grid.nx_pad + cx + 1
    return torch.where(keep, flat, 0)


def cell_index(v: torch.Tensor, origin: float, inv: np.float32,
               lo: int, hi: int) -> torch.Tensor:
    """``clip(floor((v - origin) * inv), lo, hi)`` as int64, in float32 with
    the reference's rounding (origin and inv rounded to float32 once).  The
    clip runs before the integer conversion, so out-of-range floats saturate
    instead of wrapping."""
    c = torch.floor((v - float(np.float32(origin))) * float(inv))
    return torch.clamp(c, lo, hi).to(torch.int64)


def inv_cell(grid: GridSpec2D) -> np.float32:
    """``1 / cell_size`` as the reference twins compute it (double division,
    one rounding to float32)."""
    return np.float32(1.0 / grid.cell_size)


def cell_coords(x: torch.Tensor, y: torch.Tensor, grid: GridSpec2D,
                origin=None):
    """Clamped integer cell coordinates for component position arrays [N];
    ``origin`` (ox, oy) overrides the grid's world origin (a slab's)."""
    ox, oy = (grid.origin_x, grid.origin_y) if origin is None else origin
    inv = inv_cell(grid)
    return (cell_index(x, ox, inv, 0, grid.nx - 1),
            cell_index(y, oy, inv, 0, grid.ny - 1))


def cell_ids(x: torch.Tensor, y: torch.Tensor, grid: GridSpec2D,
             origin=None) -> torch.Tensor:
    """Linear cell id ``cx + cy * nx`` (int64[N])."""
    cx, cy = cell_coords(x, y, grid, origin)
    return cx + cy * grid.nx


def stable_rank(cid: torch.Tensor) -> torch.Tensor:
    """Within-group rank of each element of ``cid`` (int64 [n], original
    order): a stable sort by id, ranks from each run's start, one scatter
    back, so equal ids rank in original-index order."""
    return stable_order(cid)[1]


def stable_order(cid: torch.Tensor):
    """(perm, rank): ``stable_rank``'s sort order (the original index of
    the i-th element by id) and its ranks.  With the ids sorted, the
    leftmost position of each one's own value is the start of its run: a
    binary search a query, all in parallel (not a running max: PyTorch
    scans a 1-D tensor in one block)."""
    perm = torch.argsort(cid, stable=True)
    sorted_cell = cid[perm]
    pos = torch.arange(cid.shape[0], device=cid.device)
    seg_start = torch.searchsorted(sorted_cell, sorted_cell)
    rank = torch.empty_like(pos)
    rank[perm] = pos - seg_start
    return perm, rank


def bin_particles(x: torch.Tensor, y: torch.Tensor,
                  grid: GridSpec2D) -> Binned:
    """Bin N particles: clamped cell coords, their ``stable_order``."""
    cx, cy = cell_coords(x, y, grid)
    perm, rank = stable_order(cx + cy * grid.nx)
    with span("bgf.read.overflow"):
        overflow = int((rank >= grid.cap).sum())
    return Binned(cx=cx, cy=cy, rank=rank, overflow=overflow, grid=grid,
                  perm=perm)


def sort_field(binned: Binned, field: torch.Tensor) -> torch.Tensor:
    """Permute a per-particle field into sorted (cell-contiguous) order."""
    return field[binned.perm]


def to_dense(binned: Binned, field: torch.Tensor, fill) -> torch.Tensor:
    """Scatter a per-particle field [N] (ORIGINAL order) into dense cell
    slots [ny_pad, cap, nx_pad]; empty slots and the ghost border hold
    ``fill``; overflowed particles (rank >= cap) are dropped: they write
    ``fill`` into the ghost slot at flat index 0, which holds it already."""
    out = torch.full(binned.grid.plane_shape, fill, dtype=field.dtype,
                     device=field.device)
    out.view(-1)[binned.slot] = torch.where(binned.keep, field, fill)
    return out


def from_dense(binned: Binned, dense: torch.Tensor,
               fallback: float = 0.0) -> torch.Tensor:
    """Per-particle values (ORIGINAL order) of a dense [ny_pad, cap,
    nx_pad] field; overflowed particles (rank >= cap) get ``fallback``."""
    return from_dense_multi(binned, [dense], [fallback])[0]


def from_dense_multi(binned: Binned, denses, fallbacks):
    """``from_dense`` of several dense fields at the binning's slots."""
    return [torch.where(binned.keep, d.reshape(-1)[binned.slot], fb)
            for d, fb in zip(denses, fallbacks)]


def gather_slots(grid: GridSpec2D, cx, cy, rank, denses, fallbacks):
    """Per-particle values of several dense fields at raw slot coordinates;
    particles without a slot (rank >= cap) get their field's fallback."""
    keep = rank < grid.cap
    slot = slot_index(grid, cx, cy, rank, keep)
    return [torch.where(keep, d.reshape(-1)[slot], fb)
            for d, fb in zip(denses, fallbacks)]
