"""Neighbour candidates by a cell list, in plain PyTorch.

Sources are binned into square cells of side ``h`` (the interaction
radius) over their own bounding box, sorted by cell, and each query point
visits the sources of its 3 x 3 cells: every source within ``h`` of the
query is among them.  Queries are taken in blocks, so the temporaries are
a block's, not the whole set's.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 22   # query points per block


class CellList:
    """Sources ``(sx, sy)`` sorted into cells of side ``h``."""

    def __init__(self, sx: torch.Tensor, sy: torch.Tensor, h: float):
        self.h = float(h)
        self.x0 = float(sx.min()) - self.h
        self.y0 = float(sy.min()) - self.h
        self.ncx = int(math.floor((float(sx.max()) - self.x0) / self.h)) + 2
        self.ncy = int(math.floor((float(sy.max()) - self.y0) / self.h)) + 2
        key = self.key(sx, sy)
        self.order = torch.argsort(key)
        counts = torch.bincount(key, minlength=self.ncx * self.ncy)
        self.count = counts
        self.start = torch.cumsum(counts, 0) - counts
        del key

    def cells(self, qx: torch.Tensor, qy: torch.Tensor):
        """Integer cell coordinates of points, clamped to the list's box."""
        cx = torch.floor((qx.double() - self.x0) / self.h).long()
        cy = torch.floor((qy.double() - self.y0) / self.h).long()
        return cx.clamp(0, self.ncx - 1), cy.clamp(0, self.ncy - 1)

    def key(self, qx, qy) -> torch.Tensor:
        cx, cy = self.cells(qx, qy)
        return cy * self.ncx + cx

    def candidates(self, qx: torch.Tensor, qy: torch.Tensor, lo: int,
                   hi: int):
        """Yield ``(j, ok)`` for the queries ``[lo, hi)``: ``j`` [hi - lo]
        source indices, ``ok`` whether the candidate exists.  Every source
        in the 3 x 3 cells of each query is yielded once."""
        cx, cy = self.cells(qx[lo:hi], qy[lo:hi])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nx, ny = cx + dx, cy + dy
                inside = (nx >= 0) & (nx < self.ncx) & (ny >= 0) \
                    & (ny < self.ncy)
                cell = torch.where(inside, ny * self.ncx + nx, 0)
                cnt = torch.where(inside, self.count[cell], 0)
                first = self.start[cell]
                for k in range(int(cnt.max()) if cnt.numel() else 0):
                    ok = cnt > k
                    pos = torch.where(ok, first + k, 0)
                    yield self.order[pos], ok


def blocks(n: int, block: int = BLOCK):
    """``[lo, hi)`` ranges of at most ``block`` items covering ``n``."""
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)
