"""The bookkeeping rules of one step under the refless trigger, the
memory-ceiling posture's (``refless_trigger=True``): the state keeps no
rebin reference planes (they are (1, 1, 1) placeholders), and ``disp2``
is the sum of each step's largest move since the last rebin, unsquared.
``checks.structure_faults`` tests the ref-based trigger through the
reference planes, so it cannot judge this posture; these rules read no
reference plane.  A step's ``structure`` faults, beside the ids (each
particle once before and after the step) and the slots (``bands``):

- the counters: ``step`` + 1, ``age`` 0 after a rebin (else + 1), ``lost``
  unchanged, ``rebin_count`` + 0 or + 1;
- the trigger: the step rebinned if and only if the ``disp2`` it was given
  exceeded half the skin (outside ``checks.TOL_TRIGGER``), or the bins
  were ``max_age`` steps old;
- the sum: ``disp2`` after the step is (0 after a rebin, else the one it
  was given) plus the square root of the step's largest squared move over
  the particles in slots, within float32 rounding;
- the bound the trigger rests on: every particle in a slot lies within its
  slot's cell grown by the state's ``disp2`` (it has moved no farther
  since the rebin that put it there), before and after the step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import checks
from reference import raster

ULPS = 2   # float32 rounding allowed in the summed displacement


def counter_faults(pre: dict, post: dict) -> int:
    """Faults of the host counters (``pre``/``post``: the states'
    ``age``, ``step``, ``rebin_count``, ``lost``)."""
    rebinned = post["rebin_count"] == pre["rebin_count"] + 1
    return (int(post["rebin_count"] not in (pre["rebin_count"],
                                            pre["rebin_count"] + 1))
            + int(post["step"] != pre["step"] + 1)
            + int(post["age"] != (0 if rebinned else pre["age"]) + 1)
            + int(post["lost"] != pre["lost"]))


def trigger_fault(disp2: float, age: int, rebinned: bool, sc: dict) -> int:
    """Whether the rebin decision contradicts the refless trigger on the
    state the step was given (its ``disp2`` and ``age``)."""
    s = checks.skin_half(sc)
    if age >= int(sc["max_age"]):
        return int(not rebinned)
    if abs(disp2 - s) > checks.TOL_TRIGGER * s:
        return int(rebinned != (disp2 > s))
    return 0


def summed(disp2: torch.Tensor, rebinned: bool,
           move2: torch.Tensor) -> torch.Tensor:
    """The ``disp2`` the rule wants after a step, in float32: (0 after a
    rebin, else the given ``disp2``) plus the square root of the step's
    largest squared move ``move2``."""
    base = torch.zeros_like(disp2) if rebinned else disp2
    return base.float() + torch.sqrt(move2.float())


def sum_fault(got: torch.Tensor, want: torch.Tensor) -> int:
    """Whether the step's ``disp2`` is off the sum by more than float32
    rounding (``ULPS`` units in the last place)."""
    g, w = float(got), float(want)
    if not (np.isfinite(g) and np.isfinite(w)):
        return 1
    ulp = float(np.spacing(np.float32(max(abs(w), 1e-30))))
    return int(abs(g - w) > ULPS * ulp)


def move2(pre_x, pre_y, post_x, post_y) -> torch.Tensor:
    """The largest squared move of the particles, in float32 as the
    program's K2 computes it (each product and the sum rounded)."""
    if pre_x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=pre_x.device)
    dx = post_x.float() - pre_x.float()
    dy = post_y.float() - pre_y.float()
    return (dx * dx + dy * dy).max()


def outside_reach(x, y, cx, cy, sc: dict, reach: float) -> int:
    """Particles farther than ``reach`` (m, plus ``checks.TOL_CELL`` cells)
    from the cell (cx, cy) of their slot."""
    g = raster.grid_geometry(sc)
    cell = g["cell"]
    pad = reach / cell + checks.TOL_CELL

    def ok(c, u, cmax):
        lo = torch.floor(u - pad).clamp(0, cmax - 1)
        hi = torch.floor(u + pad).clamp(0, cmax - 1)
        return (c >= lo) & (c <= hi)

    u = (x.double() - g["ox"]) / cell
    v = (y.double() - g["oy"]) / cell
    return int((~(ok(cx, u, g["nx"]) & ok(cy, v, g["ny"]))).sum())
