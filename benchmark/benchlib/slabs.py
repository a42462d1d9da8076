"""The slab deployment's side of the benchmark: the seeded dam break split
into x-slabs through the program's ``ShardedSession`` (one process, every
slab on the run's device), its posture checked, and the benchmark's own
reading of the slabs' state into particle order with the rules of the slab
bookkeeping.

Each slab holds the single card's dense planes ``[rows, cap, cols]`` on
its own part of the grid: real columns ``1..nx_local``, a ghost lane a side
(column 0 and ``nx_local + 1``) that the step's halo fills from the
neighbour's edge column, and a spill buffer of parked particles.  A
particle is read from its slot in a real column, or from a spill entry
with an id.  Nothing here computes physics or calls the program's
extraction: it only reads what the program holds.

The slab rules (``slab_faults``), beside the single card's
(``checks.structure_faults``, on this reading):

- every id ``0..n-1`` is held exactly once across the slabs' real columns
  and spill buffers, and no slot or entry holds an id out of that range;
- a real column's slot holds an id exactly where its position is live;
- no slot outside the real columns holds an id (the rebin moves every
  capture into its new slab, and the halo carries no ids); the outer
  ghost lanes, and the columns past them, hold no live position; each
  inner ghost lane is live exactly where the neighbour's edge column is
  (the halo's copy, which the step's kernels keep live), and empty before
  the first step;
- each slab's ``alive`` counter is its real columns' live slots.
"""

from __future__ import annotations

import math
import random

from . import checks, dense, episodes, scene

FAR = 1e9
# ShardedSession's own posture at the dam break's sizes: every knob that
# would break the restarts from one snapshot, or change the trajectory,
# off; the fused K1 + K2 step and overflow recovery on
POSTURE = {"planar_rebin": False, "refless_trigger": False,
           "segmented": False, "donate": False}
FINGERPRINT = {"solver": "fused-pallas", "recovery": True, "refless": False}
MAX_AGE = 64    # ShardedSession's default age of the bins


def spec_of(sc: dict, n: int):
    """The configuration's ShardSpec: the single card's grid (cells of
    ``skin`` x h over the box) in ``slabs`` x-slabs, each with room for
    ``capacity_factor`` times an even share of the particles."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    slabs = int(sc["slabs"])
    return shard.ShardSpec.build(
        h=float(sc["h"]) * float(sc["skin"]), x_min=sc["x_min"],
        x_max=sc["x_max"], y_max=sc["y_max"], n_devices=slabs,
        capacity=int(math.ceil(n / slabs) * float(sc["capacity_factor"])),
        cap=int(sc["cap"]))


def session(ctx, inputs: dict):
    """The ShardedSession on the inputs, every slab on the run's device, in
    the posture it chooses by itself."""
    from bevy_gpu_fluid_tpu_torch.core.state import FluidState
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession
    sc = ctx.scene
    z = inputs["vx"]
    state = FluidState(x=inputs["x"], y=inputs["y"], vx=inputs["vx"],
                       vy=inputs["vy"], ax=z, ay=z, rho=z, p=z)
    params, cfg = episodes.constants(sc)
    spec = spec_of(sc, state.n)
    mesh = SlabMesh([ctx.device] * spec.n_devices)
    # the bins' age is passed only where it is not the session's default,
    # which a session without the knob ages them at
    age = {} if int(sc["max_age"]) == MAX_AGE \
        else {"max_age": int(sc["max_age"])}
    return ShardedSession(state, params, cfg, spec, mesh, **age)


def check_posture(sess, slabs: int, device) -> None:
    """Refuse any posture but the one the cell measures: ``slabs`` slabs,
    all on ``device``, the fused step, recovery armed, the ref-based
    trigger, the K3 rebin, the standard loop and copying halos (so a
    ShardedDenseSim kept from ``sess.sim`` stays a valid snapshot).
    RuntimeError names each difference."""
    import torch
    device = torch.device(device)
    bad = [f"{k}={getattr(sess, k)!r}" for k, v in POSTURE.items()
           if getattr(sess, k) != v]
    bad += [f"{k}={sess._fingerprint.get(k)!r}" for k, v in
            FINGERPRINT.items() if sess._fingerprint.get(k) != v]
    if sess.mesh.n != slabs or any(d != device for d in sess.mesh.devices):
        bad.append(f"mesh {sess.mesh.devices}")
    if bad:
        raise RuntimeError("the slab cell times ShardedSession's own posture "
                           f"on {slabs} slabs of {device} from a snapshot; "
                           "this session has " + ", ".join(bad))


def _real(t, nxl: int):
    return t[:, :, 1:nxl + 1]


def view(sim, spec, n: int) -> dict:
    """Per-particle arrays of a ShardedDenseSim, in ``dense.view``'s keys
    (``cx`` counts cells across the slabs, ``d * nx_local`` before slab
    d's), plus ``slab`` (the slab of a particle's slot; -1 in a spill
    buffer, or nowhere) and ``bad_ids`` (ids out of range)."""
    import torch
    g = spec.local_grid
    nxl, cap = spec.nx_local, g.cap
    dev = sim.xd[0].device
    out = dict(n=n, age=sim.age, step=sim.step, rebin_count=sim.rebin_count,
               lost=sum(sim.lost), overflow=sum(sim.overflow))
    names = [name for name, _, _ in dense.FIELDS]
    vals = {k: [] for k in (*names, "ids", "cx", "cy", "slab")}
    spill = {k: [] for k in ("x", "y", "vx", "vy", "ids")}
    prefix_bad = 0
    for d in range(sim.n_slabs):
        idx = _real(sim.idx_d[d], nxl)
        live = idx >= 0
        prefix_bad += int((live[:, 1:] & ~live[:, :-1]).sum())
        flat = torch.nonzero(live.reshape(-1)).reshape(-1).to(dev)
        vals["ids"].append(idx.reshape(-1)[flat].long().to(dev))
        for name, plane, _ in dense.FIELDS:
            src = getattr(sim, plane)[d]
            if src.shape == sim.xd[d].shape:
                v = _real(src, nxl).reshape(-1)[flat].to(dev)
            else:        # refless placeholders: no reference planes
                v = torch.full(flat.shape, float("nan"), device=dev)
            vals[name].append(v)
        vals["cx"].append(flat % nxl + d * nxl)
        vals["cy"].append(flat // (cap * nxl) - g.row0)
        vals["slab"].append(torch.full_like(flat, d))
        sp = (sim.sidx[d] >= 0).to(dev)
        spill["ids"].append(sim.sidx[d].to(dev)[sp].long())
        for k, s in (("x", "sx"), ("y", "sy"), ("vx", "svx"), ("vy", "svy")):
            spill[k].append(getattr(sim, s)[d].to(dev)[sp])
    cat = {k: torch.cat(v) for k, v in vals.items()}
    scat = {k: torch.cat(v) for k, v in spill.items()}
    ids, sids = cat["ids"], scat["ids"]
    ok, sok = (ids >= 0) & (ids < n), (sids >= 0) & (sids < n)
    out["bad_ids"] = int((~ok).sum()) + int((~sok).sum())
    ids, sids = ids[ok], sids[sok]
    out["seen"] = torch.bincount(ids, minlength=n) \
        + torch.bincount(sids, minlength=n)
    out["active"] = torch.zeros(n, dtype=torch.bool, device=dev)
    out["active"][ids] = True
    out["spilled"] = torch.zeros(n, dtype=torch.bool, device=dev)
    out["spilled"][sids] = True
    for name, _, sp_name in dense.FIELDS:
        a = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
        a[ids] = cat[name][ok]
        if sp_name is not None:
            a[sids] = scat[name][sok]
        out[name] = a
    for key in ("cx", "cy", "slab"):
        a = torch.full((n,), -1, dtype=torch.int64, device=dev)
        a[ids] = cat[key][ok]
        out[key] = a
    out["prefix_bad"] = prefix_bad
    return out


def slab_faults(sim, spec, v: dict, halo: bool = True) -> int:
    """Faults of the slab rules (the module's docstring) in one state;
    ``v`` is its ``view``.  ``halo`` False: a state no step has run on
    (the first binning), whose ghost lanes hold nothing yet."""
    nxl = spec.nx_local
    D = sim.n_slabs
    bad = v["bad_ids"]
    edge = []
    for d in range(D):
        x, idx = sim.xd[d], sim.idx_d[d]
        live_x = x < FAR * 0.5
        bad += int((_real(live_x, nxl) != (_real(idx, nxl) >= 0)).sum())
        bad += int((idx[:, :, 0] >= 0).sum()) \
            + int((idx[:, :, nxl + 1:] >= 0).sum())
        bad += int(live_x[:, :, nxl + 2:].sum())
        bad += int(sim.alive[d] != int(_real(live_x, nxl).sum()))
        edge.append((live_x[:, :, 0], live_x[:, :, 1], live_x[:, :, nxl],
                     live_x[:, :, nxl + 1]))
    bad += int(edge[0][0].sum()) + int(edge[-1][3].sum())
    for d in range(D - 1):
        left, right = edge[d], edge[d + 1]
        if halo:
            bad += int((left[3] != right[1].to(left[3].device)).sum())
            bad += int((right[0] != left[2].to(right[0].device)).sum())
        else:
            bad += int(left[3].sum()) + int(right[0].sum())
    return bad


def positions(sim, spec):
    """(x, y) of the particles in the slabs' real slots."""
    import torch
    nxl = spec.nx_local
    dev = sim.xd[0].device
    xs, ys = [], []
    for x, y in zip(sim.xd, sim.yd):
        live = _real(x, nxl) < FAR * 0.5
        xs.append(_real(x, nxl)[live].to(dev))
        ys.append(_real(y, nxl)[live].to(dev))
    return torch.cat(xs), torch.cat(ys)


def counts(sess, snap) -> tuple:
    """An episode's counters since the snapshot: (rebins, lost, overflow,
    dropped at the edge merges, re-admitted), the slabs' summed."""
    sim = sess.sim
    return (sim.rebin_count - snap.rebin_count,
            sum(sim.lost) - sum(snap.lost),
            sum(sim.overflow) - sum(snap.overflow),
            sum(sim.dropped) - sum(snap.dropped),
            sum(sim.readmitted) - sum(snap.readmitted))


def gate(sess, snap) -> tuple:
    """An episode's gates, read after the window: (lost since the snapshot,
    a device flag that every field of every slab is finite, overflow
    since it)."""
    import torch
    sim = sess.sim
    dev = sim.xd[0].device
    finite = torch.stack([torch.isfinite(p).all().to(dev)
                          for planes in (sim.xd, sim.yd, sim.vxd, sim.vyd)
                          for p in planes]).all()
    c = counts(sess, snap)
    return c[1], finite, c[2]


def build(ctx, length: int) -> dict:
    """The ShardedSession on the seeded inputs, its posture checked, its
    first binning judged (``start``), warmed up ``warmup_steps`` to the
    snapshot, then one untimed episode run a step at a time to learn which
    of its steps rebin and what it counts (as ``episodes.build`` does for
    the Session).  Returns the driver's state."""
    sc, tr = ctx.scene, ctx.traffic
    inputs = scene.dam_break(sc, ctx.seed, ctx.device)
    sess = session(ctx, inputs)
    check_posture(sess, int(sc["slabs"]), ctx.device)
    spec, n = sess.spec, sess.n
    with ctx.checking():
        v = view(sess.sim, spec, n)
        ctx.numbers["start"] = checks.start_faults(v, inputs, sc) \
            + slab_faults(sess.sim, spec, v, halo=False)
        del v
    del inputs
    sess.run(tr["warmup_steps"])
    snap = sess.sim
    rebins = []
    for s in range(length):
        before = sess.sim.rebin_count
        sess.run(1)
        if sess.sim.rebin_count != before:
            rebins.append(s)
    ctx.sync()
    episode = counts(sess, snap)
    plain = [s for s in range(length) if s not in rebins]
    rng = random.Random(scene.seed_of(ctx.seed))
    checked = sorted({rng.choice(plain or rebins),
                      rng.choice(rebins or plain)})
    ctx.log(f"{spec.n_devices} slabs of {spec.nx_local} columns; episode of "
            f"{length} steps rebins at steps {rebins}, counts (rebins, lost, "
            f"overflow, dropped, readmitted) {episode}; checked steps "
            f"{checked}")
    return dict(sess=sess, snap=snap, spec=spec, n=n, length=length,
                checked=checked, pairs={}, episode=episode)


def judge_steps(ctx, st: dict, controls=(None,)) -> dict:
    """The numbers of each held (before, after) pair, read one pair at a
    time and released, as ``episodes.judge_steps``: ``structure`` adds the
    slab rules of both states to the single card's rules."""
    out = {c: [] for c in controls}
    spec, n = st["spec"], st["n"]
    for k in sorted(st["pairs"]):
        pre, post = st["pairs"].pop(k)
        a, b = view(pre, spec, n), view(post, spec, n)
        slab = slab_faults(pre, spec, a) + slab_faults(post, spec, b)
        del pre, post
        for c in controls:
            nums = checks.step_numbers(a, b, ctx.scene, c)
            nums["structure"] += slab
            ctx.log(f"checked step {k} ({c or 'program'}): {nums}")
            out[c].append(nums)
    return out


def held_bytes(*sims) -> int:
    """Bytes of the distinct device buffers that the slab states hold
    (shared planes counted once)."""
    import dataclasses

    import torch
    seen = {}
    for sim in sims:
        for f in dataclasses.fields(sim):
            v = getattr(sim, f.name)
            for t in (v if isinstance(v, list) else [v]):
                if isinstance(t, torch.Tensor):
                    s = t.untyped_storage()
                    seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())
