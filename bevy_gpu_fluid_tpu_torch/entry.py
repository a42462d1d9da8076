"""Entry points: one step of the flagship solver, and the slab
decomposition's dry run (port of the repository's ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: one step of the deferred-
rebinning Verlet solver on the 1,024-particle dam break.  Its grid has
fewer than ``cuda_solver.MONO_MAX_BLOCKS`` row blocks, so the step is the
mono kernel K5.  ``dryrun_multichip(n)`` runs the sharded production path
over n x-slabs and checks it: the slabs all on the card by default
(``SlabMesh(n=n)``: one process, slabs may share a card), n CPU entries
with ``device="cpu"``.  The devices are picked explicitly: no subprocess,
no environment variable.

    python -m bevy_gpu_fluid_tpu_torch.entry [--cpu] [--devices 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): ``fn(state, params, cfg)`` is one step of the
    flagship solver (fresh binning, then the mono kernel K5 on this grid),
    on the 1,024-particle dam-break scene on ``device``."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver

    state = bt.init_grid(32, 32, 0.04, device)
    params = bt.FluidParams.demo()
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
    grid = verlet_solver.default_grid(0.045, -1.0, 2.5, y_max=3.0, cap=8)

    def fn(state, params, cfg):
        return verlet_solver.multi_step(state, params, cfg, grid, 1)[0]

    return fn, (state, params, cfg)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _ids_exact(planes, n: int) -> bool:
    """Every original index 0..n-1 held exactly once in ``planes``."""
    ids = torch.cat([p.reshape(-1).cpu().to(torch.int64) for p in planes])
    ids = torch.sort(ids[ids >= 0]).values
    return ids.numel() == n and bool((ids == torch.arange(n)).all())


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """The slab decomposition over ``n_devices`` slabs on the production
    path (fused K1 + K2 per slab, halos, collective rebins with migration,
    recovery armed), in three phases with the reference's assertions:

    1. an 84 x 4 block spanning every slab, its halves kicked at -5 and +5
       toward the walls, 70 steps: particles conserved, no drop, loss or
       overflow, more than one rebin, every slab populated at the end, the
       identity exact, the fields finite, both walls hit;
    2. a 9-particle crowd in one cell (cap 8) beside an inert block, 30
       steps: the init spills one particle, it is re-admitted, every index
       lives once (resident or suspended), no recoverable drop at FAR;
    3. ``ShardedSession.from_generator`` with the refless trigger, the
       planar rebin, owned planes (``donate=True``: the halo in place, K1
       writing each new density into the dead plane, where the reference
       rotates donated buffers) and the segmented driver, 40 steps in
       chunks of 13: conservation, no overflow or drop, rebins, the
       identity exact, the state finite.

    Raises RuntimeError on a failed check; returns the summary line."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.core.state import from_positions
    from bevy_gpu_fluid_tpu_torch.ops.binning import FAR
    from bevy_gpu_fluid_tpu_torch.parallel import shard, shard_verlet
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession

    dev = torch.device(device)
    mesh = (SlabMesh([dev] * n_devices) if dev.type == "cpu"
            else SlabMesh(n=n_devices))
    params = bt.FluidParams.demo()
    # dissipative bounce: walls are hit hard but slabs stay populated
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    # the Verlet skin: the slab grid is built on 1.5h cells
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=n_devices,
                                 capacity=1024)
    steps = shard_verlet.make_sharded_verlet_step(params, cfg, spec, mesh,
                                                  n=84 * 4)

    # ---- phase 1: wall to wall across every slab --------------------------
    state = bt.init_grid(84, 4, 0.04, dev)
    x0 = state.x - 0.98
    state = state.replace(x=x0, vx=torch.where(x0 < 0.75, -5.0, 5.0))
    sim = steps.init(shard.shard_state(state, spec, mesh))
    seen_min, seen_max = float("inf"), float("-inf")
    for _ in range(70):
        sim = steps.step(sim)
        for xd in sim.xd:
            live = xd[xd < FAR * 0.5]
            if live.numel():
                seen_min = min(seen_min, float(live.min()))
                seen_max = max(seen_max, float(live.max()))
    alive = sum(sim.alive)
    _check(alive == state.n, f"particles not conserved: {alive}/{state.n}")
    _check(sum(sim.dropped) == 0, "migration dropped particles")
    _check(sum(sim.lost) == 0, "the reslot window missed particles")
    _check(max(sim.overflow) == 0, "cell capacity overflowed")
    rebins = sim.rebin_count
    _check(rebins > 1, f"expected collective rebins, got {rebins}")
    per_slab = list(sim.alive)
    _check(all(c > 0 for c in per_slab),
           f"some slab ended empty: per-slab alive {per_slab}")
    _check(_ids_exact(sim.idx_d, state.n),
           "per-particle identity corrupted in the sharded path")
    fs = shard_verlet.extract_fluid_state(sim, spec, params, state.n)
    _check(bool(fs.x.isfinite().all()) and bool(fs.rho.isfinite().all()),
           "non-finite fields")
    _check(seen_min <= float(cfg.x_min) + 1e-6,
           f"left wall never hit: {seen_min}")
    _check(seen_max >= float(cfg.x_max) - 1e-6,
           f"right wall never hit: {seen_max}")

    # ---- phase 2: overflow recovery on the same step ----------------------
    # a 9-particle coincident crowd in ONE cell (cap 8) on slab 0 plus an
    # inert block keeping the far slab populated: the init spills one, the
    # rest blast apart, rebins free the cell, the spilled one re-admits
    cx, cy = np.meshgrid(np.arange(3) * 0.004 + 0.2,
                         np.arange(3) * 0.004 + 0.05)
    bx, by = np.meshgrid(np.arange(4) * 0.06 + 1.5,
                         np.arange(2) * 0.06 + 0.03)
    pos = np.concatenate([np.stack([cx.ravel(), cy.ravel()], -1),
                          np.stack([bx.ravel(), by.ravel()], -1)])
    state2 = from_positions(pos.astype(np.float32), dev)
    sim2 = steps.init(shard.shard_state(state2, spec, mesh))
    suspended0 = sim2.suspended
    _check(suspended0 >= 1, "the init crowd did not spill into the buffer")
    for _ in range(30):
        sim2 = steps.step(sim2)
    readmitted = sum(sim2.readmitted)
    _check(readmitted >= 1, "the suspended particle was never re-admitted")
    _check(_ids_exact(list(sim2.idx_d) + list(sim2.sidx), state2.n),
           "identity corrupted through suspension and re-admission")
    fs2 = shard_verlet.extract_fluid_state(sim2, spec, params, state2.n)
    _check(bool(fs2.x.isfinite().all()), "non-finite recovery fields")
    _check(bool((fs2.x < FAR * 0.5).all()),
           "a recoverable drop surfaced as FAR")

    # ---- phase 3: the very-large-N posture stack on the same slabs --------
    def gen(gi):
        x = (gi % 84).to(torch.float32) * 0.04 - 0.98
        y = (gi // 84).to(torch.float32) * 0.04
        return x, y, torch.where(x < 0.75, -5.0, 5.0), torch.zeros_like(x)

    sess = ShardedSession.from_generator(
        gen, state.n, params, cfg, spec, mesh, init_chunks=4, donate=True,
        refless_trigger=True, planar_rebin=True, segmented=True)
    _check(sess.donate and sess.refless_trigger and sess.planar_rebin
           and sess.segmented, "the posture stack was not taken")
    rho_ptrs = [r.data_ptr() for r in sess.sim.rho_d]
    sess.run(1)
    _check([r.data_ptr() for r in sess.sim.rho_d] == rho_ptrs,
           "owned planes: K1 did not write the new density into the "
           "dead plane")
    sess.run(39, chunk=13)
    alive3 = sum(sess.alive)
    _check(alive3 == state.n,
           f"the posture run lost particles: {alive3}/{state.n}")
    _check(sess.overflow == 0 and sess.dropped == 0,
           f"posture run overflow {sess.overflow}, dropped {sess.dropped}")
    rebins3 = sess.rebin_count
    _check(rebins3 > 1, "the segmented driver never ran a rebin")
    _check(_ids_exact(sess.sim.idx_d, state.n),
           "identity corrupted in the posture stack")
    _check(bool(sess.state().x.isfinite().all()), "non-finite posture state")

    return (f"dryrun_multichip({n_devices}) on {mesh.devices[0]}: ok — "
            f"fused K1 + K2 per slab, 70 steps, {rebins} collective rebins, "
            f"identity exact, both walls hit, per-slab alive {per_slab}; "
            f"recovery: {suspended0} spilled at init, {readmitted} "
            f"readmitted, {sim2.suspended} still suspended, identity exact "
            f"through suspension; posture stack (generator init + segmented "
            f"+ owned planes + refless + planar): 40 steps, {rebins3} "
            f"rebins, identity exact")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; the default is the CUDA card")
    ap.add_argument("--devices", type=int, default=8,
                    help="slabs of the dry run")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, fargs = entry(device)
    out = fn(*fargs)
    _check(bool(out.x.isfinite().all()), "entry(): non-finite step")
    print(f"entry(): ok — step {out.step}, N={out.n}, on {out.x.device}")
    print(dryrun_multichip(args.devices, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
