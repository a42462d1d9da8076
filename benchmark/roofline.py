"""The least time the card could take for a launch, from its inputs.

Frozen arithmetic: it counts the work the inputs hold, not the work a
kernel's layout chooses, so a roofline share reads the same work whatever
implements it.

- Bytes: each live particle's inputs read once and its outputs written
  once (K4: each pixel written once), whatever plane layout holds them.
- Operations (float32): per interacting pair, the pairs ``(i, j)`` of live
  particles closer than ``h``, which any implementation has to evaluate;
  the density counts ``i == j`` too.  Per pair: 10 for a density tap (two
  differences, r^2 (3), h^2 - r^2, max, d^3 (2), the sum) and 29 for a
  force tap (the pressure and viscosity terms, with p and 1/rho taken once
  a particle); per particle: 3 for the equation of state and 20 for K2's
  integrate, bounce and displacement epilogue.  These are the per-tap
  counts the repo's chip smoke test used; its fault was to multiply live
  slots by each row block's slot bound, which the kernel's layout chooses.

Peaks: NVIDIA H100 SXM5 data sheet (dense, no sparsity, 700 W): 3.35 TB/s
of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import dataclasses

import torch

from reference.neighbours import CellList, blocks
from reference.raster import grid_geometry

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

DENSITY_OPS = 10
FORCE_OPS = 29
EOS_OPS = 3
INTEGRATE_OPS = 20
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and float32 operations of one launch."""

    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    def scaled(self, k: float) -> "Work":
        return Work(self.bytes * k, self.ops * k)

    @property
    def least_s(self) -> float:
        """The larger of the bytes over the memory rate and the operations
        over the float32 rate."""
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / F32_FLOPS)


def pairs_within(x, y, h: float, qx=None, qy=None) -> int:
    """Ordered pairs closer than ``h``: of the points (x, y) among
    themselves, each with itself included, or of the query points (qx,
    qy) with the points."""
    if qx is None:
        qx, qy = x, y
    cl = CellList(x, y, h)
    xs, ys = x.double(), y.double()
    qx, qy = qx.double(), qy.double()
    h2 = float(h) * float(h)
    total = 0
    for lo, hi in blocks(qx.shape[0]):
        for j, ok in cl.candidates(qx, qy, lo, hi):
            dx = qx[lo:hi] - xs[j]
            dy = qy[lo:hi] - ys[j]
            total += int((ok & (dx * dx + dy * dy < h2)).sum())
    return total


def k1(n: int, pairs: int) -> Work:
    """K1, density: x, y in, rho out."""
    return Work(3 * F32 * n, DENSITY_OPS * pairs)


def k2(n: int, pairs: int) -> Work:
    """K2, forces + integrate with the ref-based trigger: x, y, vx, vy,
    rho and the two reference positions in; x, y, vx, vy out."""
    return Work(11 * F32 * n,
                FORCE_OPS * (pairs - n) + (EOS_OPS + INTEGRATE_OPS) * n)


def k8(n: int, pairs: int) -> Work:
    """K8, forces alone: x, y, vx, vy, rho in; ax, ay out."""
    return Work(7 * F32 * n, FORCE_OPS * (pairs - n) + EOS_OPS * n)


def k4(n: int, pixels: int, taps: int) -> Work:
    """K4, the density field: x, y in, one float a pixel out; ``taps`` the
    (pixel, particle) pairs closer than h."""
    return Work(2 * F32 * n + F32 * pixels, DENSITY_OPS * taps)


def frame(x, y, sc: dict, P: int) -> Work:
    """K4's work for a frame of the particles (x, y): the configuration's
    grid at P x P pixels a cell, each pixel's taps the particles closer
    than h to its centre."""
    g = grid_geometry(sc)
    W, H = g["nx"] * P, g["ny"] * P
    step = g["cell"] / P
    col = torch.arange(W, dtype=torch.float64, device=x.device)
    row = torch.arange(H, dtype=torch.float64, device=x.device)
    px = (g["ox"] + (col + 0.5) * step).repeat(H)
    py = (g["oy"] + (row + 0.5) * step).repeat_interleave(W)
    return k4(x.numel(), H * W, pairs_within(x, y, float(sc["h"]), px, py))


def share(least_s: float, measured_s: float) -> float | None:
    """A roofline share in %: the least time over the measured one (None
    when nothing was measured)."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s


def mean_work(works: list[Work]) -> Work:
    """The mean of a launch's work over states sampled along a window."""
    k = 1.0 / len(works)
    out = Work(0.0, 0.0)
    for w in works:
        out = out + w.scaled(k)
    return out

