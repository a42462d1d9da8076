"""A/B the mono kernel K5 (one launch a step) against the two-kernel step
K1 + K2 at small N on the card, to place ``cuda_solver.MONO_MAX_BLOCKS``
on data (port of the repo's ``tools/bench_mono_ab.py``).

``MONO_MAX_BLOCKS`` is set to 10,000 (every grid steps on K5) or 0 (none
does) before the Session is built, which reads it when it makes its step,
and restored afterwards.  The timed window is the reference's
differential one: ``--warmup`` steps to develop the flow, then from one
snapshot the best of 3 runs of ``--steps`` and of 2 x ``--steps`` steps,
subtracted, so the per-call overhead cancels.  The snapshot
(``sess.sim``) is safe in the default posture: every step and rebin
returns new tensors.

    python -m bevy_gpu_fluid_tpu_torch.tools.bench_mono_ab <n_particles> <mono01>

Run pairs (mono = 1 / mono = 0) at several n and read the crossover in
``n_row_blocks``.  Prints the reference's line, then a JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import dam_break, resolve, sync


def session(n_target: int, mono: bool, device="cuda"):
    """The A/B's Session on ~``n_target`` particles (a square lattice of
    the dam break, skin 1.5 below 250,000 particles), every step on K5
    (``mono``) or on K1 + K2: ``MONO_MAX_BLOCKS`` forced while the step
    is made, then restored."""
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver, verlet_solver

    device = resolve(device)
    n = math.isqrt(n_target) ** 2
    state, params, cfg, grid, _ = dam_break(
        n, device, skin=1.75 if n >= 250_000 else 1.5)
    saved = cuda_solver.MONO_MAX_BLOCKS
    cuda_solver.MONO_MAX_BLOCKS = 10_000 if mono else 0
    try:
        return verlet_solver.Session(state, params, cfg, grid, device=device)
    finally:
        cuda_solver.MONO_MAX_BLOCKS = saved


def ab(n_target: int, mono: bool, warmup: int = 300, steps: int = 300,
       device="cuda") -> dict:
    """One arm of the A/B at ~``n_target`` particles; returns its summary
    (ms per step from the differential window, particle-steps/s, the
    grid's row blocks, overflow)."""
    device = resolve(device)
    sess = session(n_target, mono, device)
    n, grid = sess.n, sess.grid

    def run_block(k):
        sess.run(k)
        sync(device)

    run_block(warmup)                 # develop the flow
    snap = sess.sim
    bs = bl = float("inf")
    for _ in range(3):
        sess.sim = snap
        t0 = time.perf_counter()
        run_block(steps)
        bs = min(bs, time.perf_counter() - t0)
        sess.sim = snap
        t0 = time.perf_counter()
        run_block(2 * steps)
        bl = min(bl, time.perf_counter() - t0)
    d = bl - bs
    out = {"metric": "mono_ab", "mono": int(mono), "n": n,
           "n_row_blocks": grid.n_row_blocks, "per_step_ms": d / steps * 1e3,
           "rate_M": n * steps / d / 1e6, "overflow": sess.overflow,
           "device": str(device)}
    print(f"mono={int(mono)} n={n} nb={grid.n_row_blocks} "
          f"per_step={out['per_step_ms']:.3f}ms rate={out['rate_M']:.1f}M "
          f"overflow={sess.overflow}")
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="particles (a square lattice)")
    ap.add_argument("mono", type=int, choices=[0, 1],
                    help="1: every step on K5; 0: every step on K1 + K2")
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    out = ab(args.n, bool(args.mono), args.warmup, args.steps,
             "cpu" if args.cpu else "cuda")
    return 0 if out["overflow"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
