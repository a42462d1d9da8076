"""Long-horizon and resident-checkpoint validation on the card (port of
the repo's ``tools/validate_longrun.py``).

Two claims the CPU suite cannot cheaply cover, re-checked after kernel
changes:

* ``--pool``: the 25-row, 102,400-particle pool (dissipative walls,
  bounce -0.5) must run 20,000 steps with overflow 0, finite state, and
  settle (max |v| below 1).  Its grid ``[80, 8, 2560]`` has 8 row blocks,
  under ``cuda_solver.MONO_MAX_BLOCKS``, so every step is the mono kernel
  K5 and every rebin K3; the launch counters say so.
* ``--restore``: a 99,856-particle ``Session`` (K1 + K2 + K3) saved
  mid-run and restored must continue BITWISE as the uninterrupted run
  (every ``DenseSim`` field equal, counters included).  The checkpoint goes
  to a temporary directory.

    python -m bevy_gpu_fluid_tpu_torch.tools.validate_longrun --pool --restore

Each check prints the reference's summary line and a JSON line; the exit
code is 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from . import dam_break, launch_counts, launches_since, resolve, sync


def pool(rows: int = 25, cols: int = 4096, steps: int = 20_000,
         block: int = 1000, device="cuda") -> dict:
    """The long-horizon pool: ``steps`` steps in blocks of ``block``,
    stopping at the first block that ends with overflow.  Returns the
    summary: overflow, finite, max |v|, rebins, wall seconds, the step
    kernels' launches and ``ok`` (all three gates)."""
    import torch

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver

    device = resolve(device)
    state = bt.init_grid(cols, rows, 0.04, device)   # 1 unit deep at 25
    params = bt.FluidParams.demo()
    width = cols * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-0.5, x_max=width + 0.5,
                                    bounce=-0.5)
    grid = verlet_solver.default_grid(0.045, -0.5, width + 0.5,
                                      y_max=rows * 0.04 * 3 + 0.5, cap=8)
    sess = verlet_solver.Session(state, params, cfg, grid, device=device)
    before = launch_counts()
    done = 0
    t0 = time.perf_counter()
    while done < steps:
        k = min(block, steps - done)
        sess.run(k)
        sync(device)
        done += k
        if sess.overflow:
            print(f"pool: OVERFLOW {sess.overflow} at step {done}")
            break
    wall = time.perf_counter() - t0
    s = sess.state()
    vmax = float(torch.sqrt(s.vx ** 2 + s.vy ** 2).max())
    finite = all(bool(torch.isfinite(a).all())
                 for a in (s.x, s.y, s.vx, s.vy))
    ok = sess.overflow == 0 and finite and vmax < 1.0
    out = {"metric": "pool_longrun", "n": state.n, "steps": done,
           "grid": list(grid.plane_shape),
           "n_row_blocks": grid.n_row_blocks, "overflow": sess.overflow,
           "lost": sess.sim.lost, "finite": finite, "max_v": vmax,
           "rebins": sess.sim.rebin_count, "wall_s": wall,
           "launches": launches_since(before), "device": str(device),
           "ok": ok}
    print(f"pool {state.n} x {done} steps: overflow={sess.overflow} "
          f"finite={finite} max|v|={vmax:.3f} rebins={sess.sim.rebin_count} "
          f"wall={wall:.1f}s -> {'OK' if ok else 'FAIL'}")
    print(json.dumps(out))
    return out


def sims_bitwise(a, b) -> str | None:
    """The first ``DenseSim`` field where ``a`` and ``b`` differ (tensors
    bit for bit, dtype included; counters), or None."""
    import torch

    def bits(t):
        return t.reshape(-1).view(torch.int32) if t.dtype == torch.float32 \
            else t

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(bits(x), bits(y)))
        else:
            same = x == y
        if not same:
            return f.name
    return None


def restore_check(side: int = 316, steps: int = 500, device="cuda") -> dict:
    """Run ``steps``, save, run ``steps`` more; restore the checkpoint and
    run ``steps``: every field of the two DenseSims must be bitwise
    equal.  Returns the summary with ``ok``."""
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver

    device = resolve(device)
    state, params, cfg, grid, _ = dam_break(side * side, device, skin=1.75)
    a = verlet_solver.Session(state, params, cfg, grid, device=device)
    a.run(steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "validate_sess.npz")
        a.save(path)
        a.run(steps)
        b = verlet_solver.Session.restore(path, device=device)
    b.run(steps)
    sync(device)
    bad = sims_bitwise(a.sim, b.sim)
    out = {"metric": "restore_bitwise", "n": state.n,
           "grid": list(grid.plane_shape), "step": b.sim.step,
           "rebins": b.sim.rebin_count, "overflow": b.overflow,
           "mismatch": bad, "device": str(device), "ok": bad is None}
    if bad is None:
        print(f"{state.n} session restore: bitwise OK at step {b.sim.step}, "
              f"rebins {b.sim.rebin_count}, overflow {b.overflow}")
    else:
        print(f"restore: MISMATCH in {bad}")
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    if not (args.pool or args.restore):
        args.pool = args.restore = True
    device = "cpu" if args.cpu else "cuda"
    ok = True
    if args.restore:
        ok &= restore_check(device=device)["ok"]
    if args.pool:
        ok &= pool(device=device)["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
