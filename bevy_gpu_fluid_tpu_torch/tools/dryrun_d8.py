"""Multi-step D = 8 slab validation at 102,400 particles (port of the
repo's ``tools/dryrun_d8.py``).

Runs the sharded Verlet step (``shard_verlet.make_sharded_verlet_step``,
recovery armed) over D slabs long enough to cross several collective
rebins and slab migrations, then gates:

* conservation: every particle alive on some slab (alive == n);
* identity: the dense idx planes hold the permutation 0..n-1, and
  ``extract_fluid_state`` returns the state in ORIGINAL order;
* overflow == dropped == 0; positions finite and inside the bounce box;
* at least 3 rebins, and cross-slab traffic: every slab populated (the
  column is given a bulk drift so particles cross slab boundaries).

The mesh is ``SlabMesh(n=D)``: D slabs on the one card (D CPU entries with
``--cpu``), where the reference puts them on eight virtual CPU devices.
The default step is the reference's default call, the unfused slab step
on the plain stencils (``grid_solver.XLA_STENCILS``); ``--fused`` runs
K1 + K2 per slab, the production step.  Left out: the reference blocks on
every step for a 1-core CPU mesh, which a single-controller mesh does not
need.

    python -m bevy_gpu_fluid_tpu_torch.tools.dryrun_d8 --n 102400 --steps 150
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import (dam_break, identity, launch_counts, launches_since, resolve,
                slab_spec, sync)


def scene(n: int, devices: int, device):
    """The reference's scene: a square lattice of isqrt(n)^2 particles at
    spacing 0.04, every one drifting at vx = 2, and its slab spec
    (cells of 1.5 h, capacity four times an even share).  Returns (state,
    params, cfg, spec)."""
    import torch

    sc = dam_break(n, device)
    n = sc.state.n
    state = sc.state.replace(vx=torch.full((n,), 2.0, device=device))
    spec = slab_spec(n, sc.extent, 1.5, devices, -(-n // devices) * 4)
    return state, sc.params, sc.cfg, spec


def dryrun(n: int = 102_400, steps: int = 150, devices: int = 8,
           fused: bool = False, device="cuda") -> dict:
    """The dry run; returns its summary (the reference's JSON keys, the
    final FluidState under ``"state"``, the launches, ``ok``)."""
    import numpy as np

    from bevy_gpu_fluid_tpu_torch.parallel import shard, shard_verlet
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh

    device = resolve(device)
    state, params, cfg, spec = scene(n, devices, device)
    n = state.n
    mesh = (SlabMesh([device] * devices) if device.type == "cpu"
            else SlabMesh(n=devices))
    steps_fn = shard_verlet.make_sharded_verlet_step(
        params, cfg, spec, mesh, n=n, fused=fused)

    sim = steps_fn.init(shard.shard_state(state, spec, mesh))
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim = steps_fn.step(sim)
    sync(device)
    wall = time.perf_counter() - t0
    launches = launches_since(before)

    alive = sum(sim.alive)
    ovf = max(sim.overflow)
    drp = sum(sim.dropped)
    rebins = sim.rebin_count
    per_dev = [int((i >= 0).sum()) for i in sim.idx_d]
    id_ok, _ = identity(sim.idx_d, n, mesh.devices[0])

    fs = shard_verlet.extract_fluid_state(sim, spec, params, n)
    x, y = fs.x.cpu().numpy(), fs.y.cpu().numpy()
    finite = bool(np.isfinite(x).all() and np.isfinite(y).all())
    in_box = bool((x >= float(cfg.x_min) - 1e-5).all()
                  and (x <= float(cfg.x_max) + 1e-5).all()
                  and (y >= -1e-5).all())

    ok = (alive == n and ovf == 0 and drp == 0 and id_ok and finite
          and in_box and rebins >= 3 and min(per_dev) > 0)
    out = {"metric": f"dryrun_D{devices}_steps", "n": n, "steps": steps,
           "fused": fused, "rebins": rebins, "alive": alive,
           "overflow": ovf, "dropped": drp, "lost": sum(sim.lost),
           "identity_exact": id_ok, "finite": finite, "in_box": in_box,
           "per_device_alive": per_dev, "nx_local": spec.nx_local,
           "slab_grid": list(spec.local_grid.plane_shape),
           "wall_s": wall, "launches": launches, "device": str(device),
           "ok": ok}
    print(json.dumps(out))
    out["state"] = fs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=102_400)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--devices", type=int, default=8,
                    help="slabs (D), all on the card (D CPU entries with "
                         "--cpu)")
    ap.add_argument("--fused", action="store_true",
                    help="K1 + K2 per slab (the production step); the "
                         "default is the reference's unfused plain-stencil "
                         "step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    out = dryrun(args.n, args.steps, args.devices, args.fused,
                 "cpu" if args.cpu else "cuda")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
