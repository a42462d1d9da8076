"""A/B of the slot-major layout on the card: K1 and K8 on the dense planes
``[ny_pad, cap, nx_pad]`` against T2 and T3 on slot-major ones
``[cap, ny_pad, nx_pad]`` (``models/exp_kernels.density_t_cuda``,
``forces_t_cuda``), on one scene (port of the repo's
``tools/exp_tlayout.py``).

The scene is the reference's: the dam break of ``--n`` particles binned
by ``init_dense`` with cells 1.5 h.  The planes are moved to the
slot-major layout once, outside the timed loops; each kernel is timed over
``--iters`` back-to-back launches (CUDA events on the card):

    python -m bevy_gpu_fluid_tpu_torch.tools.exp_tlayout --n 1000000

Prints the reference's lines (``# max |rho_t - rho_cur| = ...``,
``density current [rows,cap,nx]: ... ms``, ``density transposed
[cap,rows,nx]: ... ms (...x)``, then the same for the forces), then a JSON
line.  The gate: T2 equal to K1 on every element of the interior rows, T3
within 1e-5 of max |a| of K8 there (it sums its taps in (kj, dy, dx)
order, K8 in (kj, dx, dy)).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import dam_break, resolve, timed_ms


def scene(n: int, device="cuda"):
    """The reference's scene: (sim, Scene) of ``init_dense`` on the dam
    break of ~``n`` particles, cells 1.5 h."""
    from ..models import verlet_solver
    device = resolve(device)
    sc = dam_break(n, device, 1.5)
    return verlet_solver.init_dense(sc.state, sc.grid), sc


def run(sim, sc, iters: int = 200, device="cuda") -> dict:
    """The A/B on ``scene``'s planes: each layout's density and forces ms,
    their ratios, the interior max |diff| of T2 against K1 and of T3
    against K8, and the gate."""
    import torch

    from ..models import cuda_solver
    from ..models import exp_kernels as ek

    device = resolve(device)
    params, grid = sc.params, sc.grid
    tb = grid.row_block
    xt, yt = ek.to_slot_major(sim.xd), ek.to_slot_major(sim.yd)
    occ_t = ek.block_kmax3_t(xt, grid)

    def interior_t(a_t, a):
        return float((ek.from_slot_major(a_t)[tb:-tb] - a[tb:-tb]).abs()
                     .max())

    rho_cur = cuda_solver.density_cuda(sim.xd, sim.yd, params, grid, sim.occ)
    rho_t = ek.density_t_cuda(xt, yt, params, grid, occ_t)
    err = interior_t(rho_t, rho_cur)
    print(f"# max |rho_t - rho_cur| = {err:.3e} (f32 order tolerance; "
          f"rho scale ~1e3)", flush=True)
    t_cur = timed_ms(lambda: cuda_solver.density_cuda(
        sim.xd, sim.yd, params, grid, sim.occ), iters, device)
    t_t = timed_ms(lambda: ek.density_t_cuda(xt, yt, params, grid, occ_t),
                   iters, device)
    print(f"density current [rows,cap,nx]: {t_cur:8.3f} ms", flush=True)
    print(f"density transposed [cap,rows,nx]: {t_t:8.3f} ms "
          f"({t_cur / t_t:.2f}x)", flush=True)

    # ---- forces ----
    vxt, vyt = ek.to_slot_major(sim.vxd), ek.to_slot_major(sim.vyd)
    fargs = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho_cur, params, grid,
             sim.occ)
    targs = (xt, yt, vxt, vyt, rho_t, params, grid, occ_t)
    a_cur = cuda_solver.forces_cuda(*fargs)
    a_t = ek.forces_t_cuda(*targs)
    ferr = max(interior_t(u, v) for u, v in zip(a_t, a_cur))
    scale = float(torch.maximum(a_cur[0].abs().max(), a_cur[1].abs().max()))
    print(f"# max |a_t - a_cur| = {ferr:.3e} (max |a| {scale:.3e})",
          flush=True)
    tf_cur = timed_ms(lambda: cuda_solver.forces_cuda(*fargs), iters, device)
    tf_t = timed_ms(lambda: ek.forces_t_cuda(*targs), iters, device)
    print(f"forces current [rows,cap,nx]: {tf_cur:8.3f} ms", flush=True)
    print(f"forces transposed [cap,rows,nx]: {tf_t:8.3f} ms "
          f"({tf_cur / tf_t:.2f}x)", flush=True)
    finite = all(bool(torch.isfinite(a).all()) for a in (rho_t, *a_t))
    ok = finite and err == 0.0 and ferr <= 1e-5 * scale
    out = {"metric": "exp_tlayout", "n": sc.state.n,
           "grid": list(grid.plane_shape), "iters": iters,
           "density_ms": t_cur, "density_t_ms": t_t,
           "forces_ms": tf_cur, "forces_t_ms": tf_t,
           "rho_max_abs_diff": err, "a_max_abs_diff": ferr,
           "max_abs_a": scale, "finite": finite, "ok": ok,
           "device": str(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    device = resolve("cpu" if args.cpu else "cuda")
    sim, sc = scene(args.n, device)
    return 0 if run(sim, sc, args.iters, device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
