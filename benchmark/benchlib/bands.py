"""The judge of a scene too large for a particle-order view beside the
program: the program's slot planes read one band of cell rows at a time.

A state is held as its planes (``Held``): the program's own (``view``,
no copy) or a copy in host memory (``hold``, made before a step that owns
its planes: the planar rebin consumes them and K1 writes the new density
into the old density plane).  A band's live slots become arrays of the
particles in them (``live``), on the card, for the band's time alone.

- ``start_faults``: the first binning.  Every live slot holds ``gen(id)``
  (``lattice.inputs`` from the seed, at rest), every id occurs once (a
  count accumulated over the bands), each particle lies in its slot's
  cell, no live slot lies above a dead one in its cell.  The number of
  ``checks.start_faults``, band by band (the same but where an id occurs
  twice with two sets of values: that one reads one of them, this one
  both).
- ``step_numbers``: one step, from the state it was given (held) to the
  state after it.  Each band of rows ``[lo, hi)`` judges the particles in
  its slots after the step.  The float64 reference (``reference.sph``)
  steps the particles in slots after the step within ``CONTEXT`` rows of
  the band (each with its values before the step, found by id among the
  slots within ``HALO`` rows and the spill buffer), and the judged ones'
  results are compared: a particle's density reads its neighbours within
  h (within one row of its slot, cells being h plus the skin), their
  accelerations the neighbours' densities (one row more), so two rows of
  context make the band's reference the whole scene's.  ``structure`` is
  the refless posture's bookkeeping (``refless``) with the ids and slots
  of ``checks.structure_faults``: each particle once before and after the
  step, after a rebin each in the cell of its position and the live slots
  a prefix of their cell, after a plain step the slots unchanged, parked
  particles unmoved, every value finite.  Nothing is sampled.
"""

from __future__ import annotations

import dataclasses

import torch

from . import checks, lattice, refless
from reference import sph

BAND_SLOTS = 1 << 27   # slots a band of rows spans, at most (one row least)
CONTEXT = 2            # rows each side whose particles the reference steps
HALO = 3               # rows each side searched for their earlier values
SEEN_POST = 256        # a particle after the step counts this in ``seen``

PLANES = (("x", "xd"), ("y", "yd"), ("vx", "vxd"), ("vy", "vyd"),
          ("idx", "idx_d"))
SPILL = (("x", "sx"), ("y", "sy"), ("vx", "svx"), ("vy", "svy"),
         ("idx", "sidx"))
COUNTERS = ("age", "step", "rebin_count", "lost", "overflow", "readmitted")
VALUES = ("x", "y", "vx", "vy")


@dataclasses.dataclass
class Held:
    """A state's planes (``x``, ``y``, ``vx``, ``vy``, ``idx``; ``rho``
    after a step), spill buffer, ``disp2`` and host counters."""

    planes: dict
    spill: dict
    disp2: torch.Tensor
    counters: dict


def view(sim) -> Held:
    """The program's own DenseSim as a Held state, nothing copied."""
    planes = {k: getattr(sim, a) for k, a in PLANES}
    planes["rho"] = sim.rho_d
    return Held(planes, {k: getattr(sim, a) for k, a in SPILL}, sim.disp2,
                {k: getattr(sim, k) for k in COUNTERS})


def hold(sim) -> Held:
    """A copy in host memory of the DenseSim's planes (no density: the step
    computes it), spill buffer and ``disp2``, before a step that owns the
    planes."""
    def copy(t):
        return t.to("cpu", copy=True)
    return Held({k: copy(getattr(sim, a)) for k, a in PLANES},
                {k: copy(getattr(sim, a)) for k, a in SPILL},
                copy(sim.disp2), {k: getattr(sim, k) for k in COUNTERS})


def band_rows(shape) -> int:
    """Rows in a band of a [rows, cap, cols] plane (``BAND_SLOTS``)."""
    return max(1, BAND_SLOTS // (shape[1] * shape[2]))


def live(state: Held, lo: int, hi: int, grid, device) -> dict:
    """The particles in the live slots of rows ``[lo, hi)`` (clipped to
    the plane), on ``device``: ``id`` (int64), the planes' values, ``row``,
    ``cx``, ``cy`` (the slot's cell) and ``prefix_bad`` (live slots above
    a dead one in their cell)."""
    rows = state.planes["idx"].shape[0]
    lo, hi = max(lo, 0), min(hi, rows)
    idx = state.planes["idx"][lo:hi].to(device)
    on = idx >= 0
    flat = torch.nonzero(on.reshape(-1)).reshape(-1)
    out = {"id": idx.reshape(-1)[flat].long()}
    for k, plane in state.planes.items():
        if k != "idx":
            out[k] = plane[lo:hi].to(device).reshape(-1)[flat]
    cols = grid.nx_pad
    out["row"] = lo + flat // (grid.cap * cols)
    out["cx"] = flat % cols - 1
    out["cy"] = out["row"] - grid.row0
    out["prefix_bad"] = int((on[:, 1:] & ~on[:, :-1]).sum())
    return out


def parked(state: Held, device) -> dict:
    """The entries of the spill buffer that hold a particle, on
    ``device``."""
    sp = state.spill["idx"].to(device)
    keep = sp >= 0
    out = {"id": sp[keep].long()}
    for k in VALUES:
        out[k] = state.spill[k].to(device)[keep]
    return out


def _count(seen: torch.Tensor, ids: torch.Tensor, weight: int) -> int:
    """Add ``weight`` to ``seen`` at each id; the ids out of range, as
    faults."""
    ok = (ids >= 0) & (ids < seen.numel())
    seen.scatter_add_(0, ids[ok], torch.full_like(ids[ok], weight,
                                                  dtype=seen.dtype))
    return int((~ok).sum())


def lookup(keys: torch.Tensor, query: torch.Tensor) -> tuple:
    """(position in ``keys`` of each query, whether it is there)."""
    if keys.numel() == 0:
        return (torch.zeros_like(query),
                torch.zeros(query.shape, dtype=torch.bool,
                            device=query.device))
    order = torch.argsort(keys)
    at = torch.searchsorted(keys[order], query).clamp_max(keys.numel() - 1)
    pos = order[at]
    return pos, keys[pos] == query


def start_faults(sim, grid, sc: dict, seed: int, n: int,
                 rows: int | None = None) -> int:
    """Faults of the program's first binning of the seeded inputs, a band
    of ``rows`` rows at a time (``band_rows`` when None)."""
    state = view(sim)
    dev = state.planes["idx"].device
    rows = rows or band_rows(state.planes["idx"].shape)
    seen = torch.zeros(n, dtype=torch.int32, device=dev)
    bad = 0
    # the spill buffer's entries (None), then each band's slots
    for lo in (None, *range(0, state.planes["idx"].shape[0], rows)):
        if lo is None:
            p = parked(state, dev)
        else:
            p = live(state, lo, lo + rows, grid, dev)
            bad += p["prefix_bad"]
        x, y = lattice.inputs(sc, seed, p["id"])
        if lo is not None:
            bad += int((~checks.cells_ok(x, y, p["cx"], p["cy"], sc)).sum())
        bad += _count(seen, p["id"], 1)
        bad += int((p["x"] != x).sum() + (p["y"] != y).sum()
                   + (p["vx"] != 0).sum() + (p["vy"] != 0).sum())
    # a missing particle's four values count as off, as in the unbanded
    # judge's particle-order view
    return bad + int((seen != 1).sum()) + 4 * int((seen == 0).sum())


def step_numbers(pre: Held, post: Held, grid, sc: dict, n: int,
                 controls=(None,), rows: int | None = None,
                 positions: list | None = None) -> dict:
    """The numbers of one step (``structure``, ``rho_rel``, ``vel_abs``,
    ``pos_abs``) for each of ``controls`` (None: the program; a key of
    ``checks.CONTROLS``: the reference at that precision in its place), a
    band of ``rows`` rows at a time.  ``pre``: the state the step was
    given, held; ``post``: the program's state after it.  ``positions``,
    when given, receives the (x, y) of the particles in slots before the
    step, in host memory."""
    dev = post.planes["idx"].device
    nrows = post.planes["idx"].shape[0]
    rows = rows or band_rows(post.planes["idx"].shape)
    rebinned = post.counters["rebin_count"] == pre.counters["rebin_count"] + 1
    bad = refless.counter_faults(pre.counters, post.counters)
    bad += refless.trigger_fault(float(pre.disp2), pre.counters["age"],
                                 rebinned, sc)
    pre_reach, post_reach = float(pre.disp2), float(post.disp2)
    seen = torch.zeros(n, dtype=torch.int32, device=dev)
    pre_park, post_park = parked(pre, dev), parked(post, dev)
    bad += _count(seen, pre_park["id"], 1)
    bad += _count(seen, post_park["id"], SEEN_POST)
    # parked particles keep their values: found among the parked ones
    # before the step, or (dropped by this step's rebin) in a slot
    park_found = torch.zeros(post_park["id"].shape, dtype=torch.bool,
                             device=dev)

    def unmoved(table: dict) -> int:
        pos, found = lookup(table["id"], post_park["id"])
        park_found.logical_or_(found)
        return int(sum((post_park[k][found] != table[k][pos[found]]).sum()
                       for k in VALUES))

    bad += unmoved(pre_park)
    worst = {c: {} for c in controls}
    most = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, nrows, rows):
        hi = min(lo + rows, nrows)
        ctx = live(post, lo - CONTEXT, hi + CONTEXT, grid, dev)
        near = live(pre, lo - HALO, hi + HALO, grid, dev)
        own_pre = (near["row"] >= lo) & (near["row"] < hi)
        own = (ctx["row"] >= lo) & (ctx["row"] < hi)
        mine = {k: v[own_pre] for k, v in near.items()
                if isinstance(v, torch.Tensor)}
        bad += _count(seen, mine["id"], 1)
        bad += _count(seen, ctx["id"][own], SEEN_POST)
        bad += refless.outside_reach(mine["x"], mine["y"], mine["cx"],
                                     mine["cy"], sc, pre_reach)
        bad += unmoved(mine)
        if positions is not None:
            positions.append((mine["x"].cpu(), mine["y"].cpu()))
        # the slots of the band after the step
        idx_post = post.planes["idx"][lo:hi]
        if rebinned:
            on = idx_post >= 0
            bad += int((on[:, 1:] & ~on[:, :-1]).sum())
        else:
            bad += int((pre.planes["idx"][lo:hi].to(dev) != idx_post).sum())
        del mine
        table = {k: torch.cat([near[k], pre_park[k]])
                 for k in ("id", *VALUES)}
        pos, found = lookup(table["id"], ctx["id"])
        bad += int((own & ~found).sum())
        if not bool((own & found).any()):
            continue
        xin = [table[k][pos[found]] for k in VALUES]
        judged = own[found]
        got = {k: ctx[k][found][judged] for k in ("rho", *VALUES)}
        bad += sum(int((~torch.isfinite(v)).sum()) for v in got.values())
        cx, cy = ctx["cx"][found][judged], ctx["cy"][found][judged]
        bad += refless.outside_reach(got["x"], got["y"], cx, cy, sc,
                                     post_reach)
        mx, my = xin[0][judged], xin[1][judged]
        most = torch.maximum(most, refless.move2(mx, my, got["x"], got["y"]))
        if rebinned:
            bad += int((~checks.cells_ok(mx, my, cx, cy, sc)).sum())
        ref = {k: v[judged] for k, v in sph.step(*xin, sc).items()}
        for c in controls:
            mine_c = got if c is None else {
                k: v[judged] for k, v in
                sph.step(*xin, sc, **checks.CONTROLS[c]).items()}
            for k, v in checks.physics(mine_c, ref).items():
                worst[c][k] = max(worst[c].get(k, v), v)
    bad += int((~park_found).sum())
    bad += int((seen != 1 + SEEN_POST).sum())
    want = refless.summed(pre.disp2.to(dev), rebinned, most)
    bad += refless.sum_fault(post.disp2, want)
    out = {}
    for c in controls:
        nums = {"rho_rel": 0.0, "vel_abs": 0.0, "pos_abs": 0.0, **worst[c]}
        out[c] = {"structure": bad, **nums}
    return out
