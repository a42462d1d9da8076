"""Throughput benchmark: particle-steps/s per card on the flagship solver
(port of the repo's ``bench.py``).

    python -m bevy_gpu_fluid_tpu_torch.tools.bench [--solver pallas]
        [--sweep] [--fps] [--frames] [--golden] [--cpu]

Prints ``bench.py``'s ONE JSON line, last on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The headline is BASELINE.json config #4: 1M particles, the full fused step
(binning + density + pressure + forces + integrate + boundaries) on the
persistent verlet ``Session`` at its default posture (K1 + K2 a step, K3 a
rebin), a dynamic dam-break scene, cells 1.75 h.  ``vs_baseline`` is value
/ 10e6, the north-star bar of >= 10M particle-steps/s per chip that
BASELINE.json sets as a target (>= 1.0: met); it is not a reading taken on
any chip.  The other modes print their lines to stderr.  Everything runs
on the CUDA card unless given ``--cpu`` (the kernels' PyTorch twins), and
raises when no card is found.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import dam_break, resolve, sync

NORTH_STAR = 10_000_000.0  # particle-steps/s/chip, BASELINE.json
SWEEP = (10_000, 100_000)
WINDOW_RUNS = 4            # runs of each length: the first use + best of 3
FPS_BATCH = 32             # frames a call in bench_fps's batched loops

# Session postures whose run from a snapshot is not bench.py's window;
# each is off in the default posture below the card's memory wall.
SNAPSHOT_BREAKERS = {
    "planar_rebin": "its rebin consumes the planes of the DenseSim it is "
                    "given, the snapshot's among them",
    "donate": "each step writes the new rho into the old rho plane, the "
              "snapshot's among them",
    "refless_trigger": "its trigger is not the ref-based one (rebins fire "
                       "earlier), so the window is not bench.py's",
    "segmented": "its driver is the memory ceiling's, not the standard run "
                 "that bench.py times",
}


def device_name(device) -> str:
    """``device`` with the card's name, for every printed reading."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    return f"{device} ({torch.cuda.get_device_name(device)})"


def check_posture(sess) -> None:
    """Refuse a ``Session`` whose posture breaks the differential window.
    The window puts ``sess.sim`` back to a snapshot, which holds only
    while no step or rebin writes into the planes or counters of the
    DenseSim it is given (the default posture: each returns new tensors and
    a new DenseSim) and the trigger is bench.py's.  RuntimeError names each
    posture that is on and why; nothing is cloned or swapped for it."""
    on = [f"{k} ({why})" for k, why in SNAPSHOT_BREAKERS.items()
          if getattr(sess, k)]
    if on:
        raise RuntimeError("the bench times the Session's default posture "
                           "from a snapshot; this Session has "
                           + "; ".join(on))


def bench_case(n_particles: int, n_steps: int, cap: int = 8,
               verbose: bool = False, solver: str = "verlet",
               warmup_steps: int = 300, skin: float = 1.5,
               device="cuda") -> dict:
    """Time a fully dynamic dam-break run on the chosen solver.

    The scene is advanced ``warmup_steps`` first (untimed) so that the
    timed window sees developed flow.  Timing is DIFFERENTIAL: from the
    same post-warm-up snapshot, the best of 3 runs of ``n_steps`` and of
    ``2 * n_steps`` steps, each ending in a synchronise, are subtracted, so
    the per-call overhead (the final synchronise and whatever else a call
    pays once) cancels and the steady per-step cost of the steps [w + n, w
    + 2n] remains.  Before the timed runs, one untimed run of each length
    builds the kernels (on first use) and warms the allocator.  The long
    run must stay inside the scene's overflow-0 regime, which the default
    300 + 300/600 horizon (step 900) does.

    ``solver="verlet"``: a ``verlet_solver.Session`` at its default
    posture (``check_posture``); ``"pallas"``: the eager solver on K1 + K8
    (``cuda_solver.multi_step``: a sort-based binning every step, so every
    step of the window rebins).

    Returns bench.py's dict (n, steps, seconds, rate, ms_per_step,
    overflow) and: ``rebins`` (the window's), ``finite``, ``t_short`` and
    ``t_long`` (seconds), ``steps_run`` and ``rebins_run`` (every step and
    Session rebin of the protocol, first-use runs included: K1 and K2 (or
    K5, or K1 and K8) launches and K3 launches on the card), the ``grid``
    and the final FluidState ``state`` (after the last long run)."""
    from ..models import cuda_solver, grid_solver, verlet_solver

    device = resolve(device)
    sc = dam_break(n_particles, device, skin, cap=cap)
    n = sc.state.n
    if solver == "verlet":
        grid = sc.grid
        sess = verlet_solver.Session(sc.state, sc.params, sc.cfg, grid,
                                     device=device)
        check_posture(sess)

        def run_from(sim, k: int) -> float:
            """``k`` steps from ``sim`` (None: from where the Session
            is); the seconds to the synchronise."""
            if sim is not None:
                sess.sim = sim
            t0 = time.perf_counter()
            sess.run(k)
            sync(device)
            return time.perf_counter() - t0

        t_first = run_from(None, warmup_steps)
        snap = sess.sim          # no step or rebin writes into it
        t_first += run_from(snap, n_steps) + run_from(snap, 2 * n_steps)
        t_short = t_long = float("inf")
        for _ in range(3):       # best-of-3 each: the diff doubles jitter
            t_short = min(t_short, run_from(snap, n_steps))
            rebins_short = sess.sim.rebin_count - snap.rebin_count
            t_long = min(t_long, run_from(snap, 2 * n_steps))
        # the counters restore with the snapshot, so long-run minus
        # short-run totals = the timed window's own rebins
        rebins_long = sess.sim.rebin_count - snap.rebin_count
        rebins = rebins_long - rebins_short
        rebins_run = (snap.rebin_count - 1      # the init's binning is 1
                      + WINDOW_RUNS * (rebins_short + rebins_long))
        overflow = sess.overflow  # whole warm-up + 2n horizon of the long run
        finite = bool(torch.isfinite(sess.sim.xd).all())
        final = sess.state()
    elif solver == "pallas":
        grid = grid_solver.default_grid(0.045, -1.0, sc.extent + 1.0,
                                        y_max=sc.extent * 1.1 + 1.0, cap=cap)

        def eager(state, k: int):
            """``k`` eager steps from ``state``: ((state, diag), seconds to
            the synchronise)."""
            t0 = time.perf_counter()
            out = cuda_solver.multi_step(state, sc.params, sc.cfg, grid, k)
            sync(device)
            return out, time.perf_counter() - t0

        (snap, _), t_first = eager(sc.state, warmup_steps)
        t_first += eager(snap, n_steps)[1] + eager(snap, 2 * n_steps)[1]
        t_short = t_long = float("inf")
        for _ in range(3):
            t_short = min(t_short, eager(snap, n_steps)[1])
            (final, diag), t = eager(snap, 2 * n_steps)
            t_long = min(t_long, t)
        overflow = int(diag.overflow)
        rebins = n_steps   # eager: every step of the timed window
        rebins_run = 0     # no Session rebin: K3 never runs
        finite = bool(torch.isfinite(final.x).all())
    else:
        raise ValueError(f"unknown solver {solver!r}")

    dt = t_long - t_short
    rate = n * n_steps / dt
    if verbose:
        print(f"# n={n} solver={solver} steps={n_steps} "
              f"(window [{warmup_steps + n_steps}, "
              f"{warmup_steps + 2 * n_steps}]) on {device_name(device)} "
              f"compile+warmup={t_first:.1f}s "
              f"short={t_short:.3f}s long={t_long:.3f}s "
              f"diff={dt:.3f}s ({dt / n_steps * 1e3:.3f} ms/step; "
              f"inclusive {t_short / n_steps * 1e3:.3f}) "
              f"dispatch~{(2 * t_short - t_long) * 1e3:.1f}ms on this "
              f"machine rebins={rebins} overflow={overflow} "
              f"finite={finite}", file=sys.stderr)
    return {"n": n, "steps": n_steps, "seconds": dt, "rate": rate,
            "ms_per_step": dt / n_steps * 1e3, "overflow": overflow,
            "rebins": rebins, "finite": finite, "t_short": t_short,
            "t_long": t_long,
            "steps_run": warmup_steps + WINDOW_RUNS * 3 * n_steps,
            "rebins_run": rebins_run, "grid": grid, "state": final}


def bench_fps(plan=(10_000, 5_041, 1_024), seconds: float = 3.0,
              substeps: int = 16, device="cuda") -> list:
    """The reference's FPS table (examples/bench_gpu.rs:36): ~``seconds``
    per loop, average frame rate to stderr.  Each frame = ``substeps`` sim
    steps (at dt=5e-4, 16 substeps per 60 Hz frame is real-time) + a
    raster on the device; every frame really integrates the scene.  The
    engine is the RESIDENT verlet facade (``Simulation`` holds a dense
    ``Session``: no per-frame re-binning or extraction of the dense
    state); frames in both raster modes: 'density' per-particle splats
    (the reference's sprite analog, 512 wide) per frame and
    ``FPS_BATCH`` frames a call (``Simulation.run_frames``), and 'field'
    (the grid-aligned density-field raster, K4) ``FPS_BATCH`` frames a
    call; each with the frames left on the device and pulled to the
    host.  Every loop is pipelined through ``FramePump`` (one frame or batch in
    flight); every counted frame is materialized (host bytes, or its CUDA
    event complete), one call late.  Each loop first runs one untimed
    call.

    Returns a dict per scene: n, the six frame rates, ``steps`` and
    ``field_frames`` (every step and field frame run, untimed ones
    included: K5 and K4 launches on the card), ``rebins`` (K3's) and
    ``overflow``."""
    import bevy_gpu_fluid_tpu_torch as bt
    from ..render.pump import FramePump

    device = resolve(device)
    batch = FPS_BATCH
    out = []
    for n in plan:
        sc = dam_break(n, device)
        sim = bt.Simulation(sc.state, sc.params, sc.cfg, sc.grid,
                            solver="verlet", raster_width=512,
                            y_view_max=sc.extent * 1.1 + 1.0, device=device)
        ran = {"steps": 0, "field_frames": 0}

        def call(mode: str, f: int):
            """One call of ``f`` frames (``run_frame`` for 1)."""
            ran["steps"] += f * substeps
            if mode == "field":
                ran["field_frames"] += f
            if f == 1:
                return sim.run_frame(substeps, mode)
            return sim.run_frames(f, substeps, mode)

        def loop(pull: bool, mode: str, f: int) -> float:
            call(mode, f)
            sync(device)
            pump = FramePump(pull=pull)
            frames = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                if pump.push(call(mode, f)) is not None:
                    frames += f
            if pump.flush() is not None:
                frames += f
            return frames / (time.perf_counter() - t0)

        fps = {"splat_device": loop(False, "density", 1),
               "splat_pulled": loop(True, "density", 1),
               "splat_batched_device": loop(False, "density", batch),
               "splat_batched_pulled": loop(True, "density", batch),
               "field_batched_device": loop(False, "field", batch),
               "field_batched_pulled": loop(True, "field", batch)}
        print(f"# fps: {sc.state.n} particles x {substeps} substeps/frame "
              f"(resident Session engine) on {device_name(device)} -> "
              f"splat per-frame {fps['splat_device']:.1f} on-device / "
              f"{fps['splat_pulled']:.1f} incl. pull; splat batched "
              f"x{batch}: {fps['splat_batched_device']:.1f} / "
              f"{fps['splat_batched_pulled']:.1f}; field batched "
              f"x{batch}: {fps['field_batched_device']:.1f} / "
              f"{fps['field_batched_pulled']:.1f}", file=sys.stderr)
        out.append({"n": sc.state.n, **fps, **ran,
                    "rebins": sim._session.sim.rebin_count - 1,
                    "overflow": sim.overflow})
    return out


def bench_frames(n: int = 1_000_000, seconds: float = 10.0,
                 substeps: int = 16, skin: float = 1.75,
                 device="cuda") -> dict:
    """BASELINE config #4: the 1M sim + the density-field raster (K4)
    streamed on the device, on the persistent dense ``Session`` (the
    state never leaves the device; frames pipelined through
    ``FramePump(pull=False)``, each counted once its CUDA event is
    complete).  One untimed frame first.  A window of thousands of steps
    on this deep column may overflow cells (recovered: the drops park in
    the spill and come back), so ``overflow`` is reported, and ``lost``
    and ``finite`` are the guarantees.

    Returns n, frames, ms_per_frame, fps, rate (particle-steps/s with the
    rendering), overflow, lost, finite, and ``steps``, ``frames_run`` and
    ``rebins`` (every step, frame and rebin, the untimed frame's
    included: K1/K2, K4 and K3 launches on the card)."""
    from ..models import verlet_solver
    from ..render.pump import FramePump

    device = resolve(device)
    sc = dam_break(n, device, skin)
    sess = verlet_solver.Session(sc.state, sc.params, sc.cfg, sc.grid,
                                 device=device)
    img = sess.run_frame(substeps)
    sync(device)
    pump = FramePump(pull=False)   # on-device streaming, pipelined
    frames = pushed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pushed += 1
        if pump.push(sess.run_frame(substeps)) is not None:
            frames += 1
    if pump.flush() is not None:
        frames += 1
    dt = time.perf_counter() - t0
    fps = frames / dt
    rate = sess.n * substeps * fps
    finite = bool(torch.isfinite(sess.sim.xd).all()
                  & torch.isfinite(sess.sim.vxd).all())
    print(f"# config4: {sess.n} particles x {substeps} substeps + "
          f"{img.shape[0]}x{img.shape[1]} field raster/frame on "
          f"{device_name(device)} -> {dt / frames * 1e3:.1f} ms/frame "
          f"({fps:.1f} FPS), {rate / 1e6:.1f}M particle-steps/s incl. "
          f"rendering, overflow={sess.overflow} lost={sess.sim.lost} "
          f"finite={finite}", file=sys.stderr)
    return {"n": sess.n, "frames": frames, "ms_per_frame": dt / frames * 1e3,
            "fps": fps, "rate": rate, "overflow": sess.overflow,
            "lost": sess.sim.lost, "finite": finite,
            "frames_run": pushed + 1, "steps": (pushed + 1) * substeps,
            "rebins": sess.sim.rebin_count - 1}


def bench_golden_step(side: int = 70, device="cuda") -> dict:
    """The reference's criterion bench (benches/step_benches.rs: step_4.9k,
    a 70x70 step): the golden model's step latency, 10 steps after 10
    untimed ones.  Returns n and ms_per_step."""
    import bevy_gpu_fluid_tpu_torch as bt
    from ..models import reference as golden

    device = resolve(device)
    state = bt.init_grid(side, side, 0.04, device)
    params = bt.FluidParams.demo()
    cfg = bt.IntegrateConfig.create()
    golden.multi_step(state, params, cfg, 10)
    sync(device)
    t0 = time.perf_counter()
    golden.multi_step(state, params, cfg, 10)
    sync(device)
    dt = (time.perf_counter() - t0) / 10
    print(f"# golden step: {state.n} particles {dt * 1e3:.3f} ms/step on "
          f"{device_name(device)}", file=sys.stderr)
    return {"n": state.n, "ms_per_step": dt * 1e3}


def parse_args(argv=None) -> argparse.Namespace:
    """bench.py's flags and defaults, and ``--cpu``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=300,
                    help="timed window length; the run is differential "
                         "(2*steps-run minus steps-run), so the scene must "
                         "stay valid to warmup+2*steps.  The default 300 "
                         "puts the measured window at steps 600-900, inside "
                         "the overflow-0 regime; longer horizons reach the "
                         "compressed phase (rebins more often, overflow>0), "
                         "slower per step: the scene, not the solver")
    ap.add_argument("--cap", type=int, default=8)
    ap.add_argument("--solver", choices=["verlet", "pallas"],
                    default="verlet",
                    help="verlet: the resident Session (K1 + K2, K3 per "
                         "rebin); pallas: the eager solver (K1 + K8, a "
                         "sort-based binning every step)")
    ap.add_argument("--warmup-steps", type=int, default=300)
    ap.add_argument("--skin", type=float, default=1.75,
                    help="verlet skin factor (cell = skin*h); 1.75 is "
                         "bench.py's choice for the dam-break scenes with "
                         "cap=8 (2.0 overflows capacity in compressed flow)")
    ap.add_argument("--sweep", action="store_true",
                    help="also run 10k/100k cases (reported to stderr)")
    ap.add_argument("--fps", action="store_true",
                    help="also run the reference's 3-case FPS table")
    ap.add_argument("--frames", action="store_true",
                    help="also run BASELINE config #4 (1M sim+render "
                         "streaming on the persistent Session)")
    ap.add_argument("--frames-skin", type=float, default=1.5,
                    help="skin for the --frames case (default 1.5: the "
                         "streaming window is 2000+ steps, where 1.75 "
                         "accumulates capacity overflow in the deep-column "
                         "scene)")
    ap.add_argument("--golden", action="store_true",
                    help="also run the golden-model step-latency bench")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The modes ``args`` asks for, in bench.py's order (golden, fps,
    frames, sweep, headline), then bench.py's JSON line on stdout.
    Returns each mode's result by name and the ``line`` printed."""
    device = "cpu" if args.cpu else "cuda"
    resolve(device)
    case = dict(cap=args.cap, verbose=True, solver=args.solver,
                warmup_steps=args.warmup_steps, skin=args.skin,
                device=device)
    out = {}
    if args.golden:
        out["golden"] = bench_golden_step(device=device)
    if args.fps:
        out["fps"] = bench_fps(device=device)
    if args.frames:
        out["frames"] = bench_frames(skin=args.frames_skin, device=device)
    if args.sweep:
        out["sweep"] = [bench_case(n, args.steps, **case) for n in SWEEP]
    r = out["headline"] = bench_case(args.n, args.steps, **case)
    out["line"] = {
        "metric": f"particle_steps_per_sec_per_chip_{args.n // 1000}k",
        "value": round(r["rate"], 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(r["rate"] / NORTH_STAR, 4),
    }
    print(json.dumps(out["line"]), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
