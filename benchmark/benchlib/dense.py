"""A per-particle view of the program's resident state, for the reference to
judge.  The Session keeps its particles in dense slot planes
``[rows, cap, cols]`` (a particle's id in ``idx_d``, -1 for an empty slot)
and parks the ones a full cell turned away in a spill buffer (``sidx``);
this reads both into arrays in particle order.  Nothing here computes
physics: it only reads what the program holds."""

from __future__ import annotations

import torch

FIELDS = (("x", "xd", "sx"), ("y", "yd", "sy"), ("vx", "vxd", "svx"),
          ("vy", "vyd", "svy"), ("rho", "rho_d", None),
          ("rx", "ref_xd", None), ("ry", "ref_yd", None))


def view(sim, grid, n: int) -> dict:
    """Per-particle arrays of a DenseSim: ``x``, ``y``, ``vx``, ``vy`` (from
    the slot or the spill buffer), ``rho``, ``rx``, ``ry`` (the slot's
    density and rebin reference; NaN in the spill), ``active`` (in a slot),
    ``spilled``, ``seen`` (times the id occurs), ``cx``, ``cy`` (the slot's
    cell; -1 in the spill), ``prefix_bad`` (slots live above a dead one in
    their cell) and the host counters."""
    dev = sim.xd.device
    idx = sim.idx_d.reshape(-1)
    flat = torch.nonzero(idx >= 0).reshape(-1)
    ids = idx[flat].long()
    sp = sim.sidx >= 0
    sids = sim.sidx[sp].long()
    out = dict(n=n, age=sim.age, step=sim.step, rebin_count=sim.rebin_count,
               lost=sim.lost, overflow=sim.overflow)
    out["seen"] = torch.bincount(ids, minlength=n) \
        + torch.bincount(sids, minlength=n)
    out["active"] = torch.zeros(n, dtype=torch.bool, device=dev)
    out["active"][ids] = True
    out["spilled"] = torch.zeros(n, dtype=torch.bool, device=dev)
    out["spilled"][sids] = True
    for name, plane, spill in FIELDS:
        a = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
        src = getattr(sim, plane)
        if src.shape == sim.xd.shape:
            a[ids] = src.reshape(-1)[flat]
        if spill is not None:
            a[sids] = getattr(sim, spill)[sp]
        out[name] = a
    cols = grid.nx_pad
    row = flat // (grid.cap * cols)
    for key, val in (("cx", flat % cols - 1), ("cy", row - grid.row0)):
        a = torch.full((n,), -1, dtype=torch.int64, device=dev)
        a[ids] = val
        out[key] = a
    live = sim.idx_d >= 0
    out["prefix_bad"] = int((live[:, 1:] & ~live[:, :-1]).sum())
    return out


def positions(sim) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of the particles in slots (what the field frame renders)."""
    live = sim.idx_d >= 0
    return sim.xd[live].clone(), sim.yd[live].clone()
