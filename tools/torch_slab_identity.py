"""How far the slab decomposition's trajectories stay identical to the
single-card Session's, on one NVIDIA GPU: bench.py's 1M dam break (as
chip_smoke.py phase 16) run in lockstep as one ``Session`` and as D = 2 and
D = 4 ``ShardedSession`` slabs on cuda:0, compared per particle by idx at
the end of every chunk.

    python3 tools/torch_slab_identity.py [--steps 400] [--chunk 25]

Per chunk it prints the rebin and overflow counts of the three runs and,
for each pair, the largest |dx| (over x and y), the number of particles
past 1e-6, the largest difference in float32 ulps of the coordinate, the
number of particles that differ at all, and the largest |dv|.  The runs
differ only in the summation order of the pair sums (a cell's slot order
after a slab's binning and the edge merges), so this reads how fast that
rounding grows through the scene's dynamics.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bevy_gpu_fluid_tpu_torch as bt  # noqa: E402
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs  # noqa: E402
from bevy_gpu_fluid_tpu_torch.parallel import shard  # noqa: E402
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh  # noqa: E402
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
    ShardedSession  # noqa: E402

N_SIDE = 1000   # bench.py's 1M scene: 1000 x 1000 at spacing 0.04


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    u = torch.abs(torch.nextafter(b, torch.full_like(b, math.inf)) - b)
    return float(((a - b).abs() / u).max())


def compare(label: str, a, b) -> None:
    dx = torch.maximum((a.x - b.x).abs(), (a.y - b.y).abs())
    dv = max(float((a.vx - b.vx).abs().max()),
             float((a.vy - b.vy).abs().max()))
    print(f"  {label}: max|dx| {float(dx.max()):.3e} n>1e-6 "
          f"{int((dx > 1e-6).sum())} ulps "
          f"{max(ulps(a.x, b.x), ulps(a.y, b.y)):.1f} n!=0 "
          f"{int((dx > 0).sum())} max|dv| {dv:.3e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_slab_identity: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    dev = torch.device("cuda", 0)
    params = bt.FluidParams.demo()
    extent = N_SIDE * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0)
    bounds = dict(h=0.045 * 1.5, x_min=-1.0, x_max=extent + 1.0,
                  y_max=extent * 1.1 + 1.0)
    grid = vs.default_grid(0.045, -1.0, extent + 1.0,
                           y_max=extent * 1.1 + 1.0)
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    one = vs.Session(state, params, cfg, grid, device=dev)
    slabs = {D: ShardedSession(
        state, params, cfg,
        shard.ShardSpec.build(n_devices=D, capacity=state.n, **bounds),
        SlabMesh([dev] * D)) for D in (2, 4)}
    steps = 0
    while steps < args.steps:
        one.run(args.chunk)
        for sess in slabs.values():
            sess.run(args.chunk)
        steps += args.chunk
        ref, a2, a4 = one.state(), slabs[2].state(), slabs[4].state()
        print(f"step {steps}: rebins one {one.sim.rebin_count - 1} D2 "
              f"{slabs[2].rebin_count - 1} D4 {slabs[4].rebin_count - 1}; "
              f"overflow {one.overflow} {slabs[2].overflow} "
              f"{slabs[4].overflow}", flush=True)
        compare("D4 vs D2", a4, a2)
        compare("D2 vs one", a2, ref)
        compare("D4 vs one", a4, ref)


if __name__ == "__main__":
    main()
