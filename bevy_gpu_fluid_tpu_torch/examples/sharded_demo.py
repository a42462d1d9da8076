"""Slab-decomposed dam-break demo: the sharded pipeline end to end, only
finished frames streamed to the host (port of ``examples/sharded_demo.py``).

A wide shallow block spanning every slab drops under gravity in a
``ShardedSession``: x-slabs over a ``SlabMesh`` (D slabs on the card by
default, D CPU entries with ``--cpu``), the fused K1 + K2 step per slab,
collective rebins with migration, per-slab raster strips joined into
frames.  The final state round-trips through ``save``/``restore`` (the
reference's sharded checkpoint), checked bitwise, and the tracked particle
identity is checked exact.

    python -m bevy_gpu_fluid_tpu_torch.examples.sharded_demo --devices 2 --frames 12
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="slabs (D): all on the card, or D CPU entries")
    ap.add_argument("--n-cols", type=int, default=80)
    ap.add_argument("--n-rows", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--substeps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bgf_torch_sharded_frames"))
    ap.add_argument("--cpu", action="store_true",
                    help="D CPU entries in the SlabMesh; the default puts "
                         "the D slabs on the CUDA card")
    return ap.parse_args(argv)


def _sims_equal(a, b) -> bool:
    """Every field of two ShardedDenseSims equal (tensors bit for bit)."""
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            if len(x) != len(y) or not all(
                    torch.equal(u.cpu(), v.cpu())
                    if isinstance(u, torch.Tensor) else u == v
                    for u, v in zip(x, y)):
                return False
        elif x != y:
            return False
    return True


def run(args: argparse.Namespace) -> dict:
    import torch

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump

    from .demo import write_ppm

    device = "cpu" if args.cpu else "cuda"
    mesh = (SlabMesh(["cpu"] * args.devices) if args.cpu
            else SlabMesh(n=args.devices))
    params = bt.FluidParams.demo()
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=args.devices,
                                 capacity=4096)

    # wide shallow block spanning every slab, dropped under gravity
    state = bt.init_grid(args.n_cols, args.n_rows, 0.04, device)
    state = state.replace(x=state.x - 0.98, y=state.y + 0.5)
    sess = ShardedSession(state, params, cfg, spec, mesh)

    os.makedirs(args.out, exist_ok=True)
    pump = FramePump(pull=True)
    shape = None
    for f in range(args.frames + 1):
        img = (pump.push(sess.run_frame(substeps=args.substeps))
               if f < args.frames else pump.flush())
        if img is None:
            continue
        k = f - 1                      # the pump hands frame k out late
        shape = img.shape
        if not img.any():
            raise RuntimeError(f"frame {k} is black")
        write_ppm(f"{args.out}/frame_{k:04d}.ppm", img)
        print(f"frame {k}: {img.shape[1]}x{img.shape[0]}, per-slab alive "
              f"{sess.alive}, rebins {sess.rebin_count}, overflow "
              f"{sess.overflow}", flush=True)

    if sum(sess.alive) != state.n:
        raise RuntimeError(f"particles not conserved: {sum(sess.alive)} of "
                           f"{state.n}")
    if sess.dropped or sess.overflow:
        raise RuntimeError(f"dropped {sess.dropped}, overflow "
                           f"{sess.overflow}")
    ids = torch.cat([i.reshape(-1).cpu() for i in sess.sim.idx_d])
    ids = torch.sort(ids[ids >= 0]).values
    if not torch.equal(ids, torch.arange(state.n, dtype=ids.dtype)):
        raise RuntimeError("per-particle identity corrupted")

    # resident checkpoint round trip, bitwise; original-order extraction
    ckpt = os.path.join(args.out, "sharded_ckpt.npz")
    sess.save(ckpt)
    back = ShardedSession.restore(ckpt, mesh)
    if not _sims_equal(back.sim, sess.sim):
        raise RuntimeError("restored session differs from the saved one")
    fs = back.state()
    if not bool(fs.x.isfinite().all()):
        raise RuntimeError("restored state not finite")
    return dict(frames=args.frames, shape=tuple(shape), n=state.n,
                alive=sess.alive, rebins=sess.rebin_count,
                restore_bitwise=True, identity_exact=True, out=args.out)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    print(f"done: {r['frames']} frames in {r['out']}, checkpoint restored "
          f"bitwise, {r['n']} particles in original order, identity exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
