"""A/B of K2 staged ahead on the card: the persistent kernel T1
(``models/exp_kernels.forces_integrate_dbuf_cuda``), which copies the next
tile's window asynchronously while it computes the current one, against
the production K2 (``cuda_solver.forces_integrate_cuda``) on one scene
(port of the repo's ``tools/exp_dbuf.py``).

The scene is the reference's: the dam break of ``--n`` particles with
cells 1.75 h, a Session run for 300 steps, rho from K1; both kernels step
the same planes against the Session's rebin references.  Each is timed
over ``--iters`` back-to-back launches (CUDA events on the card):

    python -m bevy_gpu_fluid_tpu_torch.tools.exp_dbuf --n 1000000

Prints the reference's lines (``production fused : ... ms``,
``double-buffered  : ... ms``, ``out[i] interior max abs diff: ...`` for
x, y, vx, vy), the displacement maxima, then a JSON line.  The gate: the
four planes and the displacement max equal K2's, every element.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import developed, resolve, timed_ms
from .exp_forces import interior_diff


def run(sim, sc, rho0, iters: int = 60, device="cuda") -> dict:
    """The A/B on a developed scene (``tools.developed``): both kernels'
    ms, the interior max |diff| of each output plane and the gate."""
    import torch

    from ..models import cuda_solver
    from ..models.exp_kernels import forces_integrate_dbuf_cuda

    device = resolve(device)
    args = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho0, sim.ref_xd, sim.ref_yd,
            sc.params, sc.cfg, sc.grid, sim.occ)
    t_prod = timed_ms(lambda: cuda_solver.forces_integrate_cuda(*args),
                      iters, device)
    t_dbuf = timed_ms(lambda: forces_integrate_dbuf_cuda(*args), iters,
                      device)
    print(f"production fused : {t_prod:7.3f} ms", flush=True)
    print(f"double-buffered  : {t_dbuf:7.3f} ms", flush=True)

    a = cuda_solver.forces_integrate_cuda(*args)
    b = forces_integrate_dbuf_cuda(*args)
    diffs = []
    for i in range(4):
        diffs.append(interior_diff(a[i:i + 1], b[i:i + 1], sc.grid))
        print(f"out[{i}] interior max abs diff: {diffs[i]:.3e}", flush=True)
    d2 = (float(a[4]), float(b[4]))
    print(f"disp2 max: production {d2[0]:.9e}, double-buffered "
          f"{d2[1]:.9e}", flush=True)
    same = all(torch.equal(u, v) for u, v in zip(a[:4], b[:4]))
    ok = same and d2[0] == d2[1]
    out = {"metric": "exp_dbuf", "n": sc.state.n,
           "grid": list(sc.grid.plane_shape), "iters": iters,
           "production_ms": t_prod, "dbuf_ms": t_dbuf,
           "interior_max_abs_diff": diffs, "planes_equal": same,
           "disp2": list(d2), "ok": ok, "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--steps", type=int, default=300,
                    help="Session steps that develop the flow")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    device = resolve("cpu" if args.cpu else "cuda")
    sim, sc, rho0 = developed(args.n, device, 1.75, args.steps)
    return 0 if run(sim, sc, rho0, args.iters, device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
