"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``reference/``), each as a number beside its
limit.

The reference follows the program one step at a time from the program's
own state: a dam break's trajectory is chaotic, so two float32 codes part
within a few hundred steps whatever their quality, and only a step can be
judged against a reference.  The start (the binning of the benchmark's
inputs) is judged by itself.  The numbers:

- ``start``: faults in the program's first binning: a particle missing,
  twice, off its input values, or in a slot of another cell, or a live
  slot above a dead one in its cell.  Exact, limit 0.
- ``structure``: faults in a checked step's bookkeeping: a particle
  missing or twice, a rebin where the trigger (half the skin outrun, or
  the bins ``max_age`` steps old) did not fire or none where it did, a
  rebin that left a particle in a slot of another cell or moved its rebin
  reference anywhere but to its position, a step without a rebin that
  moved a slot, a parked (spilled) particle that moved, a counter off, a
  value not finite.  Exact, limit 0.
- ``rho_rel``: the largest relative gap of a particle's density;
  ``vel_abs`` and ``pos_abs``: the largest gap of a velocity (m/s) and of
  a position (m) component after the step, each against the float64
  reference over the particles the step moved.
- ``frame_off``: the share of a frame's bytes more than one level off the
  reference's frame.
"""

from __future__ import annotations

import torch

from reference import raster, sph

TOL_CELL = 2e-3    # a position this close to a cell border (in cells) may
#                    bin either way: float32 rounding of (x - origin) / cell
TOL_TRIGGER = 1e-5  # relative band around half the skin squared

# The controls: the reference in the program's place, the whole step in
# bfloat16 (the precision below the configurations' float32), or only its
# pair sums (the state in float32).
CONTROLS = {"bfloat16": dict(dtype=torch.bfloat16),
            "bfloat16_pairs": dict(dtype=torch.float32,
                                   pair_dtype=torch.bfloat16)}


def _max(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(t).all()):
        return float("inf")
    return float(t.max())


def physics(got: dict, ref: dict) -> dict:
    """The largest gaps of density, velocity and position."""
    rho = (got["rho"].double() - ref["rho"].double()).abs() \
        / ref["rho"].double()
    vel = torch.cat([(got[k].double() - ref[k].double()).abs()
                     for k in ("vx", "vy")])
    pos = torch.cat([(got[k].double() - ref[k].double()).abs()
                     for k in ("x", "y")])
    return dict(rho_rel=_max(rho), vel_abs=_max(vel), pos_abs=_max(pos))


def cells_ok(x, y, cx, cy, sc: dict) -> torch.Tensor:
    """Whether each (x, y) lies in the cell (cx, cy) of the configuration's
    grid (positions past the grid clamp to its edge cells)."""
    g = raster.grid_geometry(sc)

    def ok(c, u, cmax):
        lo = torch.floor(u - TOL_CELL).clamp(0, cmax - 1)
        hi = torch.floor(u + TOL_CELL).clamp(0, cmax - 1)
        return (c >= lo) & (c <= hi)

    u = (x.double() - g["ox"]) / g["cell"]
    v = (y.double() - g["oy"]) / g["cell"]
    return ok(cx, u, g["nx"]) & ok(cy, v, g["ny"])


def start_faults(view: dict, inputs: dict, sc: dict) -> int:
    """Faults of the program's first binning of the inputs."""
    bad = int((view["seen"] != 1).sum()) + view["prefix_bad"]
    for k in ("x", "y", "vx", "vy"):
        bad += int((view[k] != inputs[k]).sum())
    a = view["active"]
    bad += int((~cells_ok(inputs["x"][a], inputs["y"][a], view["cx"][a],
                          view["cy"][a], sc)).sum())
    return bad


def skin_half(sc: dict) -> float:
    return (float(sc["h"]) * float(sc["skin"]) - float(sc["h"])) * 0.5


def structure_faults(pre: dict, post: dict, sc: dict) -> int:
    """Faults of one step's bookkeeping (see the module's docstring)."""
    bad = int((pre["seen"] != 1).sum()) + int((post["seen"] != 1).sum())
    rebinned = post["rebin_count"] == pre["rebin_count"] + 1
    bad += int(post["rebin_count"] not in (pre["rebin_count"],
                                           pre["rebin_count"] + 1))
    bad += int(post["step"] != pre["step"] + 1)
    bad += int(post["age"] != (0 if rebinned else pre["age"]) + 1)
    bad += int(post["lost"] != pre["lost"])
    # the trigger, from the positions and rebin references before the step
    a = pre["active"]
    d2 = ((pre["x"][a].double() - pre["rx"][a].double()) ** 2
          + (pre["y"][a].double() - pre["ry"][a].double()) ** 2)
    d2 = float(d2.max()) if d2.numel() else 0.0
    s2 = skin_half(sc) ** 2
    if pre["age"] >= int(sc["max_age"]):
        bad += int(not rebinned)
    elif abs(d2 - s2) > TOL_TRIGGER * s2:
        bad += int(rebinned != (d2 > s2))
    # the slots
    p = post["active"]
    if rebinned:
        bad += int((~cells_ok(pre["x"][p], pre["y"][p], post["cx"][p],
                              post["cy"][p], sc)).sum())
        bad += int((post["rx"][p] != pre["x"][p]).sum()
                   + (post["ry"][p] != pre["y"][p]).sum())
        bad += post["prefix_bad"]
    else:
        bad += int((post["active"] != pre["active"]).sum())
        same = p & pre["active"]
        bad += int((post["cx"][same] != pre["cx"][same]).sum()
                   + (post["cy"][same] != pre["cy"][same]).sum())
        bad += int((post["rx"][same] != pre["rx"][same]).sum()
                   + (post["ry"][same] != pre["ry"][same]).sum())
    # the spill buffer: parked particles keep their values
    s = post["spilled"]
    for k in ("x", "y", "vx", "vy"):
        bad += int((post[k][s] != pre[k][s]).sum())
        bad += int((~torch.isfinite(post[k][p])).sum())
    return bad


def step_numbers(pre: dict, post: dict, sc: dict, control=None) -> dict:
    """The numbers of one Session step: ``structure`` and the physics of
    the particles in slots after it (re-admitted ones included) from their
    values before it.  ``control`` (a key of ``CONTROLS``) puts the
    reference at that precision in the program's place."""
    p = post["active"]
    xin = [pre[k][p] for k in ("x", "y", "vx", "vy")]
    ref = sph.step(*xin, sc)
    if control is None:
        got = {k: post[k][p] for k in ("rho", "x", "y", "vx", "vy")}
    else:
        got = sph.step(*xin, sc, **CONTROLS[control])
    return dict(structure=structure_faults(pre, post, sc),
                **physics(got, ref))


def eager_numbers(pre: dict, post: dict, sc: dict, control=None) -> dict:
    """The numbers of one eager step (every particle binned anew): the
    physics of all particles, and ``structure`` (values not finite)."""
    xin = [pre[k] for k in ("x", "y", "vx", "vy")]
    ref = sph.step(*xin, sc)
    if control is None:
        got = {k: post[k] for k in ("rho", "x", "y", "vx", "vy")}
    else:
        got = sph.step(*xin, sc, **CONTROLS[control])
    bad = sum(int((~torch.isfinite(post[k])).sum())
              for k in ("x", "y", "vx", "vy", "rho"))
    return dict(structure=bad, **physics(got, ref))


def frame_numbers(x, y, got, sc: dict, P: int, control=None) -> dict:
    """``frame_off`` of one frame (``got``, uint8 [H, W, 3]) rendered from
    the particles (x, y) in slots."""
    ref = raster.frame(x, y, sc, P)
    if control is not None:
        got = raster.frame(x, y, sc, P, **CONTROLS[control])
    got = torch.as_tensor(got).to(ref.device)
    if got.shape != ref.shape:
        return dict(frame_off=1.0)
    off = (got.to(torch.int16) - ref.to(torch.int16)).abs() > 1
    return dict(frame_off=float(off.double().mean()))


def worst(readings: list[dict]) -> dict:
    """Each number's worst (largest) over several checked steps."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
