"""Benchmark of the slab path (port of the repo's ``tools/bench_sharded.py``).

Runs the sharded Verlet step (``shard_verlet``: halos, K1 + K2 per slab,
the collective rebin with migration, overflow recovery armed) over a slab
mesh and reports particle-steps/s with the conservation, overflow and
identity checks.  ``--devices D`` is D cards (``shard.make_mesh``, which
raises when there are fewer); D slabs on ONE card are
``SlabMesh(n=D)``, which ``tools.dryrun_d8`` and ``examples.sharded_demo``
drive.  The default is D = 1.

* the default mode: the fused slab step in the reference's differential
  window (``--warmup-steps``, then from one snapshot the best of 3 runs of
  ``--steps`` and of 2 x ``--steps`` steps, subtracted);
* ``--frames``: a fresh session at ``--frames-skin`` (1.5), 16 steps and
  one ``shard_render`` frame per iteration for 5 s;
* ``--scale``: the very-large-N mode, a ``ShardedSession`` with the
  memory knobs (``--chunks``, ``--planar``, ``--refless``, ``--gen``,
  ``--chunk``, ``--capacity-factor``) and owned planes, timed INCLUSIVELY
  per chunk (no snapshot).

    python -m bevy_gpu_fluid_tpu_torch.tools.bench_sharded --n 1000000 --steps 300

Prints the reference's JSON line last.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import dam_break, identity, resolve, slab_spec, sync


def _capacity(n: int, devices: int, factor: float) -> int:
    """Slab capacity: ``factor`` times an even share of ``n``."""
    return int(-(-n // devices) * factor)


def bench(args) -> dict:
    """The default mode (and ``--frames``); returns its summary."""
    from bevy_gpu_fluid_tpu_torch.parallel import (shard, shard_render,
                                                   shard_verlet)

    device = resolve("cpu" if args.cpu else "cuda")
    scene = dam_break(args.n, device, state=not args.scale)
    state, params, cfg, extent = (scene.state, scene.params, scene.cfg,
                                  scene.extent)
    n = math.isqrt(args.n) ** 2
    spec = slab_spec(n, extent, args.skin, args.devices,
                     _capacity(n, args.devices, args.capacity_factor))
    mesh = shard.make_mesh(args.devices, device.type)
    if args.scale:
        return scale_mode(args, n, params, cfg, spec, mesh, device)
    # the fused production step, overflow recovery armed (n=)
    steps = shard_verlet.make_sharded_verlet_step(params, cfg, spec, mesh,
                                                  fused=True, n=n)

    def run_k(sim, k):
        for _ in range(k):
            sim = steps.step(sim)
        sync(device)
        return sim

    sim = steps.init(shard.shard_state(state, spec, mesh))
    # the differential window, as bench.py's: a steps- and a 2 x steps-run
    # from the same snapshot (every step and rebin of this posture returns
    # new tensors), subtracted: the per-call overhead cancels
    t0 = time.perf_counter()
    snap = run_k(sim, args.warmup_steps)
    t_warm = time.perf_counter() - t0
    t_short = t_long = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_k(snap, args.steps)
        t_short = min(t_short, time.perf_counter() - t0)
        t0 = time.perf_counter()
        sim = run_k(snap, 2 * args.steps)
        t_long = min(t_long, time.perf_counter() - t0)
    dt = t_long - t_short

    alive = sum(sim.alive)
    ovf = max(sim.overflow)
    drp = sum(sim.dropped)
    rate = n * args.steps / dt
    id_ok, _ = identity(sim.idx_d, n, mesh.devices[0])
    out = {"metric": f"sharded_verlet_psteps_per_sec_D{args.devices}",
           "value": rate, "unit": "particle-steps/s",
           "ok": alive == n and ovf == 0 and drp == 0 and id_ok, "n": n,
           "ms_per_step": dt / args.steps * 1e3,
           "inclusive_ms_per_step": t_short / args.steps * 1e3,
           "warmup_s": t_warm, "alive": alive, "overflow": ovf,
           "dropped": drp, "rebins": sim.rebin_count, "identity_exact": id_ok,
           "device": str(device)}
    print(f"# sharded-verlet D={args.devices} n={n} warmup={t_warm:.1f}s "
          f"{out['ms_per_step']:.3f} ms/step = {rate / 1e6:.1f}M "
          f"particle-steps/s (differential; inclusive "
          f"{out['inclusive_ms_per_step']:.3f} ms/step) | alive {alive}/{n} "
          f"overflow={ovf} dropped={drp} rebins={sim.rebin_count} "
          f"identity={'exact' if id_ok else 'BROKEN'}", file=sys.stderr)

    if args.frames:
        # a fresh sim on its own shallower-skin grid: the streaming window
        # runs past 1,500 steps of the tall column, where skin 1.75 brushes
        # the cells' capacity (bench.py --frames-skin)
        fspec = slab_spec(n, extent, args.frames_skin, args.devices,
                          _capacity(n, args.devices, 2.0))
        fsteps = shard_verlet.make_sharded_verlet_step(
            params, cfg, fspec, mesh, fused=True, n=n)
        frame_fn = shard_render.make_sharded_frame(params, fspec, mesh)

        def frame_step(s):
            for _ in range(16):
                s = fsteps.step(s)
            return s, frame_fn(s)

        sim_f = fsteps.init(shard.shard_state(state, fspec, mesh))
        for _ in range(max(1, args.warmup_steps // 16)):
            sim_f, img = frame_step(sim_f)
        sync(device)
        frames = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.frames_seconds:
            sim_f, img = frame_step(sim_f)
            sync(device)
            frames += 1
        fdt = (time.perf_counter() - t0) / frames
        out.update(frame_ms=fdt * 1e3, frames_per_s=1 / fdt,
                   frame_psteps_per_sec=n * 16 / fdt,
                   frame_shape=list(img.shape),
                   frames_overflow=max(sim_f.overflow),
                   frames_lost=sum(sim_f.lost) + sum(sim_f.dropped))
        print(f"# sharded step+render D={args.devices}: {fdt * 1e3:.1f} "
              f"ms/frame ({1 / fdt:.1f} FPS) at {img.shape[0]}x"
              f"{img.shape[1]} = {n * 16 / fdt / 1e6:.1f}M particle-steps/s "
              f"incl. rendering, overflow={max(sim_f.overflow)}",
              file=sys.stderr)
    print(json.dumps(out))
    return out


def scale_mode(args, n, params, cfg, spec, mesh, device) -> dict:
    """The very-large-N sharded run: ``ShardedSession`` with owned planes
    and the memory knobs, ``run(chunk=)``, inclusive best-of-reps timing
    with a line per chunk (steady = the best chunk)."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession

    g = spec.local_grid
    print(f"# scale mode: D={args.devices} n={n} local grid "
          f"{g.ny_pad}x{g.cap}x{g.nx_pad} "
          f"(~{8 * g.ny_pad * g.cap * g.nx_pad * 4 / 2**30:.1f} GiB "
          f"resident dense a slab, capacity={spec.capacity})",
          file=sys.stderr, flush=True)
    knob = {"auto": None, "on": True, "off": False}
    kw = dict(planar_rebin=knob[args.planar],
              refless_trigger=knob[args.refless], init_chunks=args.chunks,
              donate=True)
    side = math.isqrt(n)
    t0 = time.perf_counter()
    if args.gen:
        sess = ShardedSession.from_generator(
            bt.lattice_gen(side, 0.04, device), n, params, cfg, spec, mesh,
            **kw)
    else:
        state = bt.init_grid(side, side, 0.04, device)
        sess = ShardedSession(state, params, cfg, spec, mesh, **kw)
        del state
    sync(device)
    t_init = time.perf_counter() - t0
    ck = args.chunk or None

    t0 = time.perf_counter()
    if args.warmup_steps:
        sess.run(args.warmup_steps, chunk=ck)
        sync(device)
    t_warm = time.perf_counter() - t0

    best = steady = float("inf")
    kk = ck or args.steps
    for _ in range(args.reps):
        t0 = time.perf_counter()
        done = 0
        while done < args.steps:
            c = min(kk, args.steps - done)
            tc = time.perf_counter()
            sess.run(c)
            sync(device)
            dt = time.perf_counter() - tc
            print(f"#   chunk {done}+{c}: {dt / c * 1e3:.2f} ms/step",
                  file=sys.stderr, flush=True)
            steady = min(steady, dt / c)
            done += c
        best = min(best, time.perf_counter() - t0)
    rate = n / steady

    alive = sum(sess.alive)
    ovf, drp = sess.overflow, sess.dropped
    id_ok, live = identity(sess.sim.idx_d, n, mesh.devices[0])
    id_ok = id_ok and live == alive
    finite = all(bool(x.isfinite().all()) for x in sess.sim.xd)  # FAR too
    ok = alive == n and ovf == 0 and drp == 0 and id_ok and finite
    out = {"metric": f"sharded_scale_psteps_per_sec_{n // 1_000_000}M_D"
                     f"{args.devices}",
           "value": rate, "unit": "particle-steps/s", "ok": ok, "n": n,
           "ms_per_step": steady * 1e3,
           "inclusive_ms_per_step": best / args.steps * 1e3,
           "init_s": t_init, "warmup_s": t_warm, "alive": alive,
           "overflow": ovf, "dropped": drp, "suspended": sess.suspended,
           "rebins": sess.rebin_count, "planar": sess.planar_rebin,
           "refless": sess.refless_trigger, "identity_exact": id_ok,
           "finite": finite, "device": str(device)}
    print(f"# sharded-scale D={args.devices} n={n} init={t_init:.1f}s "
          f"warmup={t_warm:.1f}s {steady * 1e3:.2f} ms/step steady "
          f"(inclusive {out['inclusive_ms_per_step']:.2f}) = "
          f"{rate / 1e6:.1f}M particle-steps/s | alive {alive}/{n} "
          f"overflow={ovf} dropped={drp} suspended={sess.suspended} "
          f"rebins={sess.rebin_count} "
          f"rebin_mode={'planar' if sess.planar_rebin else 'fused'} "
          f"refless={sess.refless_trigger} "
          f"identity={'exact' if id_ok else 'BROKEN'} finite={finite}",
          file=sys.stderr)
    print(json.dumps(out))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup-steps", type=int, default=300)
    ap.add_argument("--devices", type=int, default=1,
                    help="cards, one slab each (shard.make_mesh: raises "
                         "when there are fewer); D slabs on one card are "
                         "SlabMesh(n=D), as tools.dryrun_d8 runs them")
    ap.add_argument("--skin", type=float, default=1.75)
    ap.add_argument("--frames", action="store_true",
                    help="also time the sharded step + render loop (16 "
                         "steps and one shard_render frame per iteration)")
    ap.add_argument("--frames-skin", type=float, default=1.5,
                    help="skin of the --frames session (the streaming "
                         "window runs 1,500+ steps of the deep column, "
                         "where 1.75 brushes the cells' capacity)")
    ap.add_argument("--frames-seconds", type=float, default=5.0,
                    help="length of the --frames timing window")
    ap.add_argument("--scale", action="store_true",
                    help="very-large-N mode (the sharded twin of "
                         "tools.bench_scale): ShardedSession with owned "
                         "planes and the memory knobs, inclusive timing")
    ap.add_argument("--chunks", type=int, default=16,
                    help="[--scale] init_chunks of the chunked init")
    ap.add_argument("--planar", choices=["auto", "on", "off"],
                    default="auto", help="[--scale] planar rebin")
    ap.add_argument("--chunk", type=int, default=0,
                    help="[--scale] run(chunk=K): K-step calls")
    ap.add_argument("--refless", choices=["auto", "on", "off"],
                    default="auto", help="[--scale] refless trigger")
    ap.add_argument("--gen", action="store_true",
                    help="[--scale] generator init "
                         "(ShardedSession.from_generator): no [N] state "
                         "and no [capacity] buffers on the card")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--capacity-factor", type=float, default=2.0,
                    help="per-slab particle buffer as a multiple of n/D")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return 0 if bench(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
