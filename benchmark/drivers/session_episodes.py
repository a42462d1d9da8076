"""Traffic of whole episodes through ``Session.run``: each restarts from
the snapshot after the warm-up and runs ``episode_steps`` steps, back to
back, in one closed loop, until the first episode to end past the
window's length.  Reports particle-steps per second over the whole window
(restores and synchronises included)."""

from __future__ import annotations

import time

from benchlib import checks, dense, episodes

END_TO_END = ("particle_steps_per_s",)


def setup(ctx):
    return episodes.build(ctx, ctx.traffic["episode_steps"])


def window(ctx, st, seconds, tracer) -> dict:
    sess, snap, length = st["sess"], st["snap"], st["length"]
    gates = []
    eps = steps = rebins = 0
    marks = []
    t0 = time.perf_counter()
    while True:
        tracer.begin(eps)
        st["pairs"].clear()
        with tracer.span("bench.restore"):
            sess.sim = snap
        episodes.run_steps(st, 0, length, tracer.span)
        gates.append(episodes.gate(sess, snap))
        rebins += sess.sim.rebin_count - snap.rebin_count
        with tracer.span("bench.sync"):
            ctx.sync()
        eps += 1
        marks.append(time.perf_counter())
        steps += length
        if time.perf_counter() - t0 >= seconds or tracer.done(eps):
            tracer.stop(ctx.sync)
            break
    dt = time.perf_counter() - t0
    held = [snap, *(s for p in st["pairs"].values() for s in p), sess.sim]
    return dict(held_bytes=episodes.held_bytes(*held),
                episode_s=episodes.durations(t0, marks),
                attempted=eps, failed=episodes.failed(gates), seconds=dt,
                steps=steps, rebins=rebins,
                overflow=sum(g[2] for g in gates),
                metrics={"particle_steps_per_s": sess.n * steps / dt})


def finish(ctx, st) -> None:
    if ctx.trace_on:
        pre = [p[0] for p in st["pairs"].values()]
        ctx.positions = [dense.positions(s) for s in
                         (st["snap"], *pre, st["sess"].sim)]
    st["sess"] = st["snap"] = None
    for c, readings in episodes.judge_steps(ctx, st, ctx.controls).items():
        ctx.readings[c] = checks.worst(readings)
    ctx.numbers.update(ctx.readings[None])
