"""Traffic of whole episodes through ``ShardedSession.run`` on x-slabs:
each restarts from the snapshot after the warm-up and runs
``episode_steps`` steps, back to back, in one closed loop, until the first
episode to end past the window's length (``session_episodes``' traffic,
with the dam break split into ``slabs`` slabs driven by one process).
Reports particle-steps per second over the whole window (restores and
synchronises included).  Every episode does the same work, so each has to
count what the untimed episode of set-up counted (rebins, lost, overflow,
edge-merge drops, re-admissions); an episode that does not is a fault of
``structure``.  A traced run also matches the device operations launched
inside the program's halo spans (``halo_device_s``)."""

from __future__ import annotations

import time

from benchlib import checks, episodes, slab_readers, slabs

END_TO_END = ("particle_steps_per_s",)


def setup(ctx):
    return slabs.build(ctx, ctx.traffic["episode_steps"])


def window(ctx, st, seconds, tracer) -> dict:
    sess, snap, length = st["sess"], st["snap"], st["length"]
    gates, marks, counted = [], [], []
    eps = steps = 0
    traced = None
    t0 = time.perf_counter()
    while True:
        tracer.begin(eps)
        st["pairs"].clear()
        with tracer.span("bench.restore"):
            sess.sim = snap
        episodes.run_steps(st, 0, length, tracer.span)
        gates.append(slabs.gate(sess, snap))
        counted.append(slabs.counts(sess, snap))
        with tracer.span("bench.sync"):
            ctx.sync()
        eps += 1
        marks.append(time.perf_counter())
        steps += length
        if time.perf_counter() - t0 >= seconds or tracer.done(eps):
            prof = tracer.prof
            tracer.stop(ctx.sync)
            if prof is not None:
                traced = slab_readers.launched_in(
                    prof.profiler.kineto_results.events(), tracer.trace,
                    slab_readers.HALO)
            break
    dt = time.perf_counter() - t0
    st["counted"] = counted
    held = [snap, *(s for p in st["pairs"].values() for s in p), sess.sim]
    return dict(held_bytes=slabs.held_bytes(*held),
                episode_s=episodes.durations(t0, marks),
                attempted=eps, failed=episodes.failed(gates), seconds=dt,
                steps=steps, rebins=sum(c[0] for c in counted),
                overflow=sum(g[2] for g in gates),
                **({} if traced is None else {"halo_device_s": traced}),
                metrics={"particle_steps_per_s": sess.n * steps / dt})


def finish(ctx, st) -> None:
    if ctx.trace_on:
        pre = [p[0] for p in st["pairs"].values()]
        ctx.positions = [slabs.positions(s, st["spec"]) for s in
                         (st["snap"], *pre, st["sess"].sim)]
    st["sess"] = st["snap"] = None
    # every episode restarts from the snapshot: one that counts otherwise
    # than the untimed episode did is a fault of the slabs' bookkeeping
    differ = sum(c != st["episode"] for c in st.pop("counted", []))
    if differ:
        ctx.log(f"{differ} episodes counted otherwise than set-up's "
                f"{st['episode']}")
    for c, readings in slabs.judge_steps(ctx, st, ctx.controls).items():
        worst = checks.worst(readings)
        worst["structure"] = worst.get("structure", 0) + differ
        ctx.readings[c] = worst
    ctx.numbers.update(ctx.readings[None])
