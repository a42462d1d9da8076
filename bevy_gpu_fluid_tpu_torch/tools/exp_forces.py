"""A/B of K8's pair arithmetic on the card: the five variants of T4
(``models/exp_kernels.forces_variant_cuda``) on one scene (port of the
repo's ``tools/exp_forces.py``).

    v0    K8's own arithmetic (bitwise K8)
    v0nr  v0 with the rsqrt replaced by r^2 + EPS (wrong physics: it only
          prices the rsqrt)
    v1    constants folded: C1 = (-m/2) spiky_c, C2 = mu m visc_c,
          u = (p_i + p_j) / rho_j
    v2    v1 with v_i factored out of the pair loop (a third sum)
    v3    v2 with the slot loop unrolled by two (bitwise v2)

The scene is the reference's: the dam break of ``--n`` particles with
cells ``--skin`` x h, a Session run for 300 steps so the occupancy is the
flow's, then rho from K1.  Each variant is timed in two interleaved passes
over ``--iters`` back-to-back launches (CUDA events on the card), and held
against v0 on the interior row blocks:

    python -m bevy_gpu_fluid_tpu_torch.tools.exp_forces --n 1000000

Prints the reference's lines (``pass{k} {variant} ... ms``, ``{variant}
best ... ms``, ``{variant} vs v0 interior max abs diff: ...``), then a JSON
line.  The gate: every output finite, v1, v2 and v3 within 1e-5 of
max |a| of v0 (v0nr is wrong by design and only reported).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import developed, resolve, timed_ms

PASSES = 2


def interior_diff(a, b, grid) -> float:
    """max |a - b| over both planes' interior row blocks."""
    tb = grid.row_block
    return max(float((u[tb:-tb] - v[tb:-tb]).abs().max())
               for u, v in zip(a, b))


def run(sim, sc, rho0, iters: int = 40, device="cuda") -> dict:
    """The A/B on a developed scene (``tools.developed``): each variant's
    ms per pass and best, its interior max |diff| against v0, v0's max |a|
    and the gate."""
    import torch

    from ..models.exp_kernels import VARIANTS, forces_variant_cuda

    device = resolve(device)
    args = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho0, sc.params, sc.grid,
            sim.occ)
    times = {v: [] for v in VARIANTS}
    for k in range(PASSES):        # two interleaved passes: expose noise
        for v in VARIANTS:
            t = timed_ms(lambda v=v: forces_variant_cuda(*args, v), iters,
                         device)
            times[v].append(t)
            print(f"pass{k} {v:6s} {t:7.3f} ms", flush=True)
    for v in VARIANTS:
        print(f"{v:6s} best {min(times[v]):7.3f} ms", flush=True)

    # v1-v3 must match v0 to f32 noise; v0nr is wrong on purpose
    a0 = forces_variant_cuda(*args, "v0")
    scale = float(torch.maximum(a0[0].abs().max(), a0[1].abs().max()))
    finite = all(bool(torch.isfinite(a).all()) for a in a0)
    diff = {}
    for v in VARIANTS[1:]:
        av = forces_variant_cuda(*args, v)
        finite &= all(bool(torch.isfinite(a).all()) for a in av)
        diff[v] = interior_diff(a0, av, sc.grid)
        print(f"{v} vs v0 interior max abs diff: {diff[v]:.3e}", flush=True)
    ok = finite and all(diff[v] <= 1e-5 * scale for v in ("v1", "v2", "v3"))
    out = {"metric": "exp_forces", "n": sc.state.n,
           "grid": list(sc.grid.plane_shape), "iters": iters,
           "pass_ms": times, "best_ms": {v: min(t) for v, t in times.items()},
           "diff_vs_v0": diff, "max_abs_a": scale, "finite": finite,
           "ok": ok, "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--skin", type=float, default=1.75)
    ap.add_argument("--steps", type=int, default=300,
                    help="Session steps that develop the flow")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    device = resolve("cpu" if args.cpu else "cuda")
    sim, sc, rho0 = developed(args.n, device, args.skin, args.steps)
    return 0 if run(sim, sc, rho0, args.iters, device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
