"""The Session's side of the step and frame cells: building the program's
Session on the seeded dam break, the warm-up to a developed flow and the
snapshot every episode restarts from, and an episode's steps with the
states before and after its checked steps held for the comparison.

The episodes restart from one snapshot (``sess.sim = snap``, as the port's
bench does), so every episode of every run does the same work whatever
the code's speed.  That holds for the Session's default posture, in which
no step or rebin writes into the planes of the state it is given; the
port's ``tools.bench.check_posture`` refuses any other."""

from __future__ import annotations

import dataclasses
import random

from . import checks, dense, scene


def constants(sc: dict):
    """The program's FluidParams and IntegrateConfig of a configuration."""
    import bevy_gpu_fluid_tpu_torch as bt
    return (bt.FluidParams.create(sc["h"], sc["rho_0"], sc["k"], sc["mu"],
                                  sc["m"]),
            bt.IntegrateConfig.create(dt=sc["dt"], x_min=sc["x_min"],
                                      x_max=sc["x_max"], bounce=sc["bounce"],
                                      floor_y=sc["floor_y"]))


def build(ctx, length: int) -> dict:
    """The Session on the seeded inputs, its first binning judged (the
    ``start`` number), warmed up ``warmup_steps`` to the snapshot, then one
    untimed episode run a step at a time to learn which of its steps
    rebin (episodes of ``length`` steps).  Returns the driver's state."""
    from bevy_gpu_fluid_tpu_torch.core.state import FluidState
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    from bevy_gpu_fluid_tpu_torch.tools import bench
    sc, tr = ctx.scene, ctx.traffic
    inputs = scene.dam_break(sc, ctx.seed, ctx.device)
    z = inputs["vx"]
    state = FluidState(x=inputs["x"], y=inputs["y"], vx=inputs["vx"],
                       vy=inputs["vy"], ax=z, ay=z, rho=z, p=z)
    params, cfg = constants(sc)
    grid = verlet_solver.default_grid(sc["h"], sc["x_min"], sc["x_max"],
                                      y_max=sc["y_max"], cap=sc["cap"],
                                      skin_factor=sc["skin"])
    sess = verlet_solver.Session(state, params, cfg, grid, device=ctx.device,
                                 max_age=sc["max_age"])
    bench.check_posture(sess)
    with ctx.checking():
        ctx.numbers["start"] = checks.start_faults(
            dense.view(sess.sim, grid, sess.n), inputs, sc)
    del state, inputs, z
    sess.run(tr["warmup_steps"])
    snap = sess.sim
    rebins = []
    for s in range(length):
        before = sess.sim.rebin_count
        sess.run(1)
        if sess.sim.rebin_count != before:
            rebins.append(s)
    ctx.sync()
    plain = [s for s in range(length) if s not in rebins]
    rng = random.Random(scene.seed_of(ctx.seed))
    checked = sorted({rng.choice(plain or rebins),
                      rng.choice(rebins or plain)})
    ctx.log(f"episode of {length} steps rebins at steps {rebins}; checked "
            f"steps {checked}")
    return dict(sess=sess, snap=snap, grid=grid, n=sess.n, length=length,
                checked=checked, pairs={})


def run_steps(st: dict, first: int, count: int, span) -> None:
    """Steps ``[first, first + count)`` of an episode through
    ``Session.run``, holding the state before and after each checked
    step (``st["pairs"][k]``)."""
    sess = st["sess"]
    done = first
    end = first + count
    for k in st["checked"]:
        if not done <= k < end:
            continue
        with span("bench.session_run"):
            sess.run(k - done)
        pre = sess.sim
        with span("bench.session_run"):
            sess.run(1)
        st["pairs"][k] = (pre, sess.sim)
        done = k + 1
    with span("bench.session_run"):
        sess.run(end - done)


def gate(sess, snap) -> tuple:
    """An episode's gates, read after the window: (lost since the snapshot,
    a device flag that every field is finite, overflow since it)."""
    import torch
    sim = sess.sim
    finite = torch.stack([torch.isfinite(p).all() for p in
                          (sim.xd, sim.yd, sim.vxd, sim.vyd)]).all()
    return sim.lost - snap.lost, finite, sim.overflow - snap.overflow


def failed(gates: list) -> int:
    """Episodes that lost a particle or hold a value not finite."""
    import torch
    if not gates:
        return 0
    finite = torch.stack([g[1] for g in gates]).cpu().tolist()
    return sum(1 for g, ok in zip(gates, finite) if g[0] > 0 or not ok)


def judge_steps(ctx, st: dict, controls=(None,)) -> dict:
    """The numbers of each held (before, after) pair, the program's states
    read into particle order one pair at a time and released: for each of
    ``controls`` (None: the program; a key of ``checks.CONTROLS``: the
    reference at that precision in its place), each pair's numbers."""
    out = {c: [] for c in controls}
    grid, n = st["grid"], st["n"]
    for k in sorted(st["pairs"]):
        pre, post = st["pairs"].pop(k)
        a, b = dense.view(pre, grid, n), dense.view(post, grid, n)
        del pre, post
        for c in controls:
            nums = checks.step_numbers(a, b, ctx.scene, c)
            ctx.log(f"checked step {k} ({c or 'program'}): {nums}")
            out[c].append(nums)
    return out


def held_bytes(*sims) -> int:
    """Bytes of the distinct device buffers that the states hold (shared
    planes counted once)."""
    import torch
    seen = {}
    for sim in sims:
        for f in dataclasses.fields(sim):
            t = getattr(sim, f.name)
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def durations(t0: float, marks: list) -> list:
    """The least, median and largest of the episodes' seconds, from the
    window's start and each episode's end (for the run's log)."""
    d = sorted(b - a for a, b in zip([t0, *marks], marks))
    return [round(d[0], 4), round(d[len(d) // 2], 4), round(d[-1], 4)]
