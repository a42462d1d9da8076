"""Traffic of the eager solver: ``cuda_solver.multi_step`` (a sort-based
binning of every particle, K1 and K8 every step, no resident state) on
the grid of cells ``cell_factor`` x h.  The warm-up's state after
``warmup_steps`` is the snapshot; each episode runs ``episode_steps``
steps from it, back to back, in one closed loop.  Reports particle-steps
per second over the whole window."""

from __future__ import annotations

import random
import time

from benchlib import checks, episodes, scene

END_TO_END = ("particle_steps_per_s",)


def setup(ctx):
    import torch

    from bevy_gpu_fluid_tpu_torch.core.state import FluidState
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
    sc, tr = ctx.scene, ctx.traffic
    inputs = scene.dam_break(sc, ctx.seed, ctx.device)
    z = torch.zeros_like(inputs["x"])
    state = FluidState(x=inputs["x"], y=inputs["y"], vx=inputs["vx"],
                       vy=inputs["vy"], ax=z, ay=z, rho=z, p=z)
    params, cfg = episodes.constants(sc)
    grid = grid_solver.default_grid(sc["h"] * tr["cell_factor"], sc["x_min"],
                                    sc["x_max"], y_max=sc["y_max"],
                                    cap=sc["cap"])

    def steps(s, k):
        return cuda_solver.multi_step(s, params, cfg, grid, k)

    snap, _ = steps(state, tr["warmup_steps"])
    del state, inputs
    steps(snap, tr["episode_steps"])           # the untimed episode
    ctx.sync()
    rng = random.Random(scene.seed_of(ctx.seed))
    return dict(steps=steps, snap=snap, n=snap.n,
                checked=rng.randrange(tr["episode_steps"]))


def window(ctx, st, seconds, tracer) -> dict:
    import torch
    steps, snap, length = st["steps"], st["snap"], ctx.traffic["episode_steps"]
    k = st["checked"]
    gates = []
    eps = 0
    marks = []
    t0 = time.perf_counter()
    while True:
        tracer.begin(eps)
        st["pair"] = None
        with tracer.span("bench.eager_run"):
            pre, d0 = steps(snap, k)
            post, d1 = steps(pre, 1)
            last, d2 = steps(post, length - k - 1)
        st["pair"] = (pre, post, d1.overflow)
        finite = torch.stack([torch.isfinite(t).all() for t in
                              (last.x, last.y, last.vx, last.vy)]).all()
        gates.append((max(d0.overflow, d1.overflow, d2.overflow), finite))
        with tracer.span("bench.sync"):
            ctx.sync()
        eps += 1
        marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds or tracer.done(eps):
            tracer.stop(ctx.sync)
            break
    dt = time.perf_counter() - t0
    ok = torch.stack([g[1] for g in gates]).cpu().tolist()
    return dict(episode_s=episodes.durations(t0, marks),
                attempted=eps, failed=sum(1 for f in ok if not f),
                seconds=dt, steps=eps * length,
                overflow=max(g[0] for g in gates),
                metrics={"particle_steps_per_s":
                         snap.n * eps * length / dt})


def finish(ctx, st) -> None:
    pre, post, overflow = st.pop("pair")
    if ctx.trace_on:
        ctx.positions = [(s.x, s.y) for s in (st["snap"], pre, post)]
    st["snap"] = None
    ctx.log(f"checked step {st['checked']}: overflow {overflow}")
    a = {k: getattr(pre, k) for k in ("x", "y", "vx", "vy")}
    b = {k: getattr(post, k) for k in ("rho", "x", "y", "vx", "vy")}
    for c in ctx.controls:
        ctx.readings[c] = checks.eager_numbers(a, b, ctx.scene, c)
        ctx.log(f"checked step {st['checked']} ({c or 'program'}): "
                f"{ctx.readings[c]}")
    ctx.numbers.update(ctx.readings[None])
