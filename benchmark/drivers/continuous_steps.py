"""Traffic of one continuous run through ``Session.run`` at the card's
memory ceiling, where no snapshot fits beside the program: the window
runs on from the warm-up's end instead of restarting episodes.

Set-up: the seeded dam break made chunk by chunk (``lattice.generator``)
into ``Session.from_generator`` with every posture left to the card; the
configuration records the posture the card must choose (``posture``) and
set-up fails if the Session chose another.  On a CPU device no posture is
automatic, so the recorded one is passed.  The first binning is judged
band by band (``bands.start_faults``, outside ``setup_s``), then
``warmup_steps`` steps run.

The window: ``window_steps`` steps in ``Session.run`` calls of
``segment_steps``, each an attempt whose gates (no particle lost, every
field finite) are read on the device and counted after the window.  It
ends on its step count, not on ``seconds``, so every run of every commit
does the same work; a traced run ends after ``trace_episodes`` segments
(and at least one rebin).  Reports particle-steps per second over the
window, the final synchronisation included.

The comparison, after the window and untimed: the run goes on to the
first step after the window and to the first step of the other kind
(plain or rebinning).  Each is judged from a host-memory copy of the
state it was given (the step owns its planes) against the Session's state
after it, still on the card, one band of rows at a time
(``bands.step_numbers``); then the Session is freed.
"""

from __future__ import annotations

import gc
import resource
import time

import numpy as np

from benchlib import bands, ceiling_readers, checks, episodes, lattice

END_TO_END = ("particle_steps_per_s",)
POSTURE = ("planar_rebin", "refless_trigger", "donate", "segmented")
ALLOCATOR_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                   "num_ooms")


def posture(sess) -> dict:
    return {k: bool(getattr(sess, k)) for k in POSTURE}


def plane_bytes(grid) -> int:
    return 4 * grid.ny_pad * grid.cap * grid.nx_pad


def setup(ctx):
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    sc, tr = ctx.scene, ctx.traffic
    side = int(sc["side"])
    n = side * side
    params, cfg = episodes.constants(sc)
    grid = verlet_solver.default_grid(sc["h"], sc["x_min"], sc["x_max"],
                                      y_max=sc["y_max"], cap=sc["cap"],
                                      skin_factor=sc["skin"])
    want = {k: bool(sc["posture"][k]) for k in POSTURE}
    knobs = {} if ctx.device.type == "cuda" else want
    t0 = time.perf_counter()
    sess = verlet_solver.Session.from_generator(
        lattice.generator(sc, ctx.seed, ctx.device), n, params, cfg, grid,
        device=ctx.device, max_age=int(sc["max_age"]), **knobs)
    ctx.sync()
    got = posture(sess)
    ctx.log(f"{n} particles ({side} x {side}), planes {grid.plane_shape} "
            f"of {plane_bytes(grid)} bytes; from_generator "
            f"{time.perf_counter() - t0:.3f} s; posture {got}")
    if got != want:
        raise RuntimeError(
            f"the Session chose the posture {got} on {ctx.device}, the "
            f"configuration records {want}: this cell runs the posture the "
            f"card chooses for itself")
    with ctx.checking():
        ctx.numbers["start"] = bands.start_faults(sess.sim, grid, sc,
                                                  ctx.seed, n)
        release(ctx)
    ctx.log(f"start faults {ctx.numbers['start']}")
    sess.run(int(tr["warmup_steps"]))
    ctx.sync()
    return dict(sess=sess, grid=grid, n=n, posture=got)


def release(ctx) -> None:
    """Hand the judge's cached device blocks back to the card, so that the
    program's next allocations find the memory they would find without
    the judge."""
    import torch
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _finite(sim):
    """A device flag: every position and velocity finite, read off each
    plane's largest and least value (NaN propagates through both), so no
    plane-sized temporary joins the program's memory."""
    import torch
    ends = [f(p) for p in (sim.xd, sim.yd, sim.vxd, sim.vyd)
            for f in (torch.amax, torch.amin)]
    return torch.isfinite(torch.stack(ends)).all()


def window(ctx, st, seconds, tracer) -> dict:
    import torch
    sess, tr = st["sess"], ctx.traffic
    per = int(tr["segment_steps"])
    segments = int(tr["window_steps"]) // per
    first = {k: getattr(sess.sim, k) for k in bands.COUNTERS}
    gates, marks, rebins = [], [], []
    segs = 0
    traced = None
    t0 = time.perf_counter()
    while segs < segments:
        tracer.begin(segs)
        lost = sess.sim.lost
        with tracer.span("bench.session_run"):
            sess.run(per)
        gates.append((sess.sim.lost - lost, _finite(sess.sim)))
        marks.append(time.perf_counter())
        rebins.append(sess.sim.rebin_count)
        segs += 1
        if tracer.done(segs) and (sess.sim.rebin_count > first["rebin_count"]
                                  or segs == segments):
            prof = tracer.prof
            tracer.stop(ctx.sync)
            traced = ceiling_readers.launched_in(
                prof.profiler.kineto_results.events(), tracer.trace)
            break
    with tracer.span("bench.sync"):
        ctx.sync()
    dt = time.perf_counter() - t0
    sim = sess.sim
    seconds = [round(b - a, 3) for a, b in zip([t0, *marks], marks)]
    counts = [b - a for a, b in zip([first["rebin_count"], *rebins], rebins)]
    ctx.log(f"segments (s, rebins): {list(zip(seconds, counts))}")
    if ctx.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(ctx.device)
        mem = torch.cuda.memory_stats(ctx.device)
        ctx.log(f"the window's memory peak {peak} bytes = "
                f"{peak / plane_bytes(st['grid']):.3f} plane-footprints "
                f"({peak / 2**30:.2f} GiB); allocator since start: "
                f"{ {k: mem.get(k) for k in ALLOCATOR_STATS} }")
    steps = segs * per
    return dict(attempted=segs, failed=episodes.failed(gates), seconds=dt,
                steps=steps, rebins=sim.rebin_count - first["rebin_count"],
                overflow=sim.overflow - first["overflow"],
                readmitted=sim.readmitted - first["readmitted"],
                suspended=sim.suspended,
                **{k: int(v) for k, v in st["posture"].items()},
                **({} if traced is None else {"rebin_device_ms": traced}),
                metrics={"particle_steps_per_s": st["n"] * steps / dt})


def _due(sim, sc: dict) -> bool:
    """Whether the refless trigger fires before the state's next step (the
    program's float32 half skin)."""
    h = np.float32(sc["h"])
    half = (np.float32(float(sc["h"]) * float(sc["skin"])) - h) \
        * np.float32(0.5)
    return sim.age >= int(sc["max_age"]) or float(sim.disp2) > float(half)


def finish(ctx, st) -> None:
    import torch
    sess, grid, n, sc = st["sess"], st["grid"], st["n"], ctx.scene
    readings = {c: [] for c in ctx.controls}
    samples = []

    def checked() -> bool:
        """Hold the state, step once, judge the step; whether it rebinned."""
        t0 = time.perf_counter()
        pre = bands.hold(sess.sim)
        step, count = sess.sim.step, sess.sim.rebin_count
        sess.run(1)
        ctx.sync()
        t1 = time.perf_counter()
        xy = [] if ctx.trace_on else None
        nums = bands.step_numbers(pre, bands.view(sess.sim), grid, sc, n,
                                  ctx.controls, positions=xy)
        del pre
        release(ctx)
        rebinned = sess.sim.rebin_count != count
        for c, v in nums.items():
            readings[c].append(v)
            ctx.log(f"checked step {step} ({'rebin' if rebinned else 'plain'}"
                    f", {c or 'program'}): {v}")
        ctx.log(f"held and stepped in {t1 - t0:.3f} s, judged in "
                f"{time.perf_counter() - t1:.3f} s")
        if xy:
            samples.append(tuple(torch.cat(v) for v in zip(*xy)))
        return rebinned

    if not checked():
        for _ in range(int(sc["max_age"]) + 1):
            if _due(sess.sim, sc):
                break
            sess.run(1)
    checked()
    st["sess"] = sess = None
    release(ctx)
    ctx.positions = [(x.to(ctx.device), y.to(ctx.device))
                     for x, y in samples]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    ctx.log(f"host memory peak {rss} bytes ({rss / 2**30:.2f} GiB)")
    for c, r in readings.items():
        ctx.readings[c] = checks.worst(r)
    ctx.numbers.update(ctx.readings[None])
