"""Very-large-N single-card scale benchmark, the memory-ceiling probe (port
of the repo's ``tools/bench_scale.py``).

The differential window of ``bench.py`` holds a snapshot after warm-up,
which keeps two copies of the dense state alive: what the card cannot
afford near its memory ceiling.  This tool drives the large-N knobs
instead: ``Session.from_generator`` (the lattice computed chunk by chunk,
``--chunks`` of them: no [N] particle tensor on the card) with
``donate=True`` (the Session owns its planes: K1 writes the new density
into the dead plane), the planar rebin and the refless trigger left to
the card's memory (``--planar auto``; ``planar_rebin_default`` and
``refless_trigger_default``).  Timing is INCLUSIVE best-of-``--reps``
(no snapshot).  Also printed: the peak device memory of the steps in
plane-footprints (``torch.cuda.max_memory_allocated`` after the init over
one dense plane's bytes).  ``ok`` is the reference's gate: overflow 0 and
finite positions.  The 96M default is past that gate on the card: its
392-unit-deep column overflows a few particles by step 1,200 (recovered:
parked and re-admitted, none lost), so the tool exits 1 there; ``lost``,
``alive`` and ``suspended`` say whether any particle went missing.

    python -m bevy_gpu_fluid_tpu_torch.tools.bench_scale --n 96000000

Left out, TPU-only: ``--dbuf`` (the Pallas kernels' DMA modes).
``--bisect K[,K2,...]`` runs the measured steps as ``Session.run`` calls of
K steps with a line after each, as the reference's fault bracketing does.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import dam_break, resolve, sync


def scale(n: int = 96_000_000, steps: int = 300, warmup: int = 300,
          chunks: int = 16, skin: float = 1.75, reps: int = 3,
          planar: str = "auto", recovery: bool = True, bisect: str = "",
          device="cuda") -> dict:
    """The scale run; returns its summary (the JSON line's keys, ms/step,
    rebins, overflow, the postures chosen, the peak in plane-footprints
    (None off the card), ``ok``)."""
    import torch

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver

    device = resolve(device)
    side = math.isqrt(n)
    n = side * side
    _, params, cfg, grid, _ = dam_break(n, device, skin, state=False)
    plane_bytes = 4 * grid.ny_pad * grid.cap * grid.nx_pad
    print(f"# n={n} grid {grid.ny_pad}x{grid.cap}x{grid.nx_pad} "
          f"(~{8 * plane_bytes / 2**30:.1f} GiB resident dense)",
          file=sys.stderr)
    on_card = device.type == "cuda"

    t0 = time.perf_counter()
    sess = verlet_solver.Session.from_generator(
        bt.lattice_gen(side, 0.04, device), n, params, cfg, grid,
        device=device, init_chunks=chunks, donate=True, recovery=recovery,
        planar_rebin={"auto": None, "on": True, "off": False}[planar])
    sync(device)
    t_init = time.perf_counter() - t0
    if on_card:         # the peak of the steps, the init's transients apart
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    if warmup:
        sess.run(warmup)
        sync(device)
    t_warm = time.perf_counter() - t0

    if bisect:
        sizes = [int(s) for s in bisect.split(",")]
        if len(sizes) == 1:
            total = steps * reps
            sizes = [min(sizes[0], total - k)
                     for k in range(0, total, sizes[0])]
        done = 0
        for k in sizes:
            t0 = time.perf_counter()
            sess.run(k)
            sync(device)
            done += k
            print(f"# step {warmup + done}: chunk={k} "
                  f"rebins={sess.sim.rebin_count} overflow={sess.overflow} "
                  f"({(time.perf_counter() - t0) / k * 1e3:.1f} ms/step)",
                  file=sys.stderr, flush=True)
        out = {"metric": "bisect", "ok": True}
        print(json.dumps(out))
        return out

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sess.run(steps)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    ms = best / steps * 1e3
    rate = n / (best / steps)
    peak = (torch.cuda.max_memory_allocated(device) / plane_bytes
            if on_card else None)
    finite = bool(torch.isfinite(sess.sim.xd).all())   # FAR is finite
    alive = int((sess.sim.xd < 5e8).sum())
    ok = sess.overflow == 0 and finite
    print(f"# init={t_init:.1f}s warmup={t_warm:.1f}s {ms:.1f} ms/step = "
          f"{rate / 1e6:.1f}M particle-steps/s "
          f"rebins={sess.sim.rebin_count} overflow={sess.overflow} "
          f"suspended={sess.suspended} finite={finite} "
          f"rebin_mode={'planar' if sess.planar_rebin else 'fused'} "
          f"refless={sess.refless_trigger} peak={peak} plane-footprints",
          file=sys.stderr)
    out = {"metric": f"scale_psteps_per_sec_{n // 1_000_000}M",
           "value": rate, "unit": "particle-steps/s", "ok": ok, "n": n,
           "ms_per_step": ms, "init_s": t_init, "warmup_s": t_warm,
           "rebins": sess.sim.rebin_count, "overflow": sess.overflow,
           "lost": sess.sim.lost, "alive": alive,
           "suspended": sess.suspended, "finite": finite,
           "planar": sess.planar_rebin, "refless": sess.refless_trigger,
           "peak_plane_footprints": peak, "device": str(device)}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=96_000_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup-steps", type=int, default=300)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--skin", type=float, default=1.75)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--planar", choices=["auto", "on", "off"],
                    default="auto",
                    help="force the plane-at-a-time rebin on/off (auto = "
                    "planar_rebin_default(grid): on near the memory "
                    "ceiling)")
    ap.add_argument("--bisect", type=str, default="", metavar="K[,K2,...]",
                    help="fault localization: after warm-up, run the "
                    "measured steps as Session.run calls of K steps (a "
                    "comma list runs exactly those in order), printing the "
                    "step, rebins and overflow after each")
    ap.add_argument("--no-recovery", action="store_true",
                    help="counted-loss overflow contract (recovery=False): "
                    "drops are counted, never collected or re-admitted")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    out = scale(args.n, args.steps, args.warmup_steps, args.chunks,
                args.skin, args.reps, args.planar, not args.no_recovery,
                args.bisect, "cpu" if args.cpu else "cuda")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
