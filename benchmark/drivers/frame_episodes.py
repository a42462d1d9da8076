"""Traffic of the video-export and viewer path: episodes of ``frames``
frames, each ``substeps`` steps through ``Session.run`` and the density
field frame (``Session.frame``, P x P pixels a cell: ``run_frame``'s two
calls, made apart so the spans can tell them apart), handed to
``FramePump(pull=True)``, which copies it into pinned host memory with one
frame in flight.  Every episode restarts from the snapshot; one closed
loop.  A frame's time runs from the start of its steps to the return of
the push that hands its host copy back."""

from __future__ import annotations

import math
import random
import time

from benchlib import checks, dense, episodes, scene

END_TO_END = ("frames_per_s", "frame_ms_p95")


def setup(ctx):
    tr = ctx.traffic
    st = episodes.build(ctx, tr["frames"] * tr["substeps"])
    sess = st["sess"]
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump
    st["pump"] = FramePump(pull=True)
    sess.sim = st["snap"]
    st["pump"].push(sess.frame(tr["px_per_cell"]))   # warm the raster
    st["pump"].flush()
    rng = random.Random(scene.seed_of(ctx.seed) + 1)
    st["checked_frame"] = rng.randrange(tr["frames"])
    return st


def window(ctx, st, seconds, tracer) -> dict:
    sess, snap, tr = st["sess"], st["snap"], ctx.traffic
    pump, sub, P = st["pump"], tr["substeps"], tr["px_per_cell"]
    gates, times = [], []
    eps = frames = rebins = 0
    in_flight = None            # (start time, frame) of the frame in flight
    marks = []
    t0 = time.perf_counter()

    def delivered(img, now):
        nonlocal in_flight
        start, f = in_flight
        times.append(now - start)
        if f == st["checked_frame"]:
            st["frame"] = img
        in_flight = None

    while True:
        tracer.begin(eps)
        st["pairs"].clear()
        with tracer.span("bench.restore"):
            sess.sim = snap
        for f in range(tr["frames"]):
            start = time.perf_counter()
            episodes.run_steps(st, f * sub, sub, tracer.span)
            with tracer.span("bench.frame"):
                img = sess.frame(P)
            if f == st["checked_frame"]:
                st["frame_sim"] = sess.sim
            with tracer.span("bench.pump_push"):
                out = pump.push(img)
            if out is not None:
                delivered(out, time.perf_counter())
            in_flight = (start, f)
            frames += 1
        gates.append(episodes.gate(sess, snap))
        rebins += sess.sim.rebin_count - snap.rebin_count
        eps += 1
        marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds or tracer.done(eps):
            with tracer.span("bench.pump_push"):
                out = pump.flush()
            delivered(out, time.perf_counter())
            tracer.stop(ctx.sync)
            break
    dt = time.perf_counter() - t0
    failed_eps = episodes.failed(gates)
    times.sort()
    p95 = times[min(len(times) - 1, math.ceil(0.95 * len(times)) - 1)]
    return dict(episode_s=episodes.durations(t0, marks),
                attempted=frames,
                failed=failed_eps * tr["frames"] + frames - len(times),
                seconds=dt, frames=frames, steps=frames * sub, rebins=rebins,
                overflow=sum(g[2] for g in gates),
                metrics={"frames_per_s": len(times) / dt,
                         "frame_ms_p95": 1e3 * p95})


def finish(ctx, st) -> None:
    tr = ctx.traffic
    ctx.frame_positions = dense.positions(st.pop("frame_sim"))
    if ctx.trace_on:
        ctx.positions = [dense.positions(s) for s in
                         (st["snap"], st["sess"].sim)]
    st["sess"] = st["snap"] = None
    x, y = ctx.frame_positions
    img = st.pop("frame")
    for c, readings in episodes.judge_steps(ctx, st, ctx.controls).items():
        readings.append(checks.frame_numbers(x, y, img, ctx.scene,
                                             tr["px_per_cell"], c))
        ctx.readings[c] = checks.worst(readings)
    ctx.numbers.update(ctx.readings[None])
