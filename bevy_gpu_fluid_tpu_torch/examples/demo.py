"""Headless dam-break demo: simulate and rasterize on the card, stream only
finished frames to the host as PPM images (port of ``examples/demo.py``).

The reference demos' scene: 5,041 particles in the dam break (``--n`` to
change), two view modes (``--mode const|density``) and a scripted drag
impulse injected mid-run.  Frames come to the host through
``render.pump.FramePump`` (one frame in flight) and go to the native
``FrameSink`` (a C++ writer thread) or, with ``--sink python``, to
synchronous writes; a sink that cannot be built raises.

    python -m bevy_gpu_fluid_tpu_torch.examples.demo --out frames --frames 60
    python -m bevy_gpu_fluid_tpu_torch.examples.demo --n 1024 --mode const --cpu

Solvers: ``verlet`` (a fresh binning per frame; K5 on this scene's grid),
``pallas`` (the eager solver on K1 + K8), ``xla`` (the eager solver on the
plain stencils), ``golden`` (all pairs).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb8.tobytes())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5041)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--substeps", type=int, default=16,
                    help="sim steps per frame (dt=0.0005 each)")
    ap.add_argument("--mode", choices=["density", "const"], default="density")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bgf_torch_frames"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    ap.add_argument("--solver", choices=["verlet", "pallas", "xla", "golden"],
                    default="verlet")
    ap.add_argument("--kick-frame", type=int, default=30,
                    help="frame at which a scripted impulse is injected")
    ap.add_argument("--sink", choices=["native", "python"], default="native",
                    help="native = async C++ FrameSink (encode/IO off the "
                         "frame loop); python = synchronous writes")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The demo's frame loop; returns its summary (frames, seconds, fps,
    dropped, written, ...)."""
    import torch

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.interact.impulse import apply_impulse
    from bevy_gpu_fluid_tpu_torch.models import (cuda_solver, grid_solver,
                                                 verlet_solver)
    from bevy_gpu_fluid_tpu_torch.models import reference as golden
    from bevy_gpu_fluid_tpu_torch.native import FrameSink
    from bevy_gpu_fluid_tpu_torch.render import raster
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump
    from bevy_gpu_fluid_tpu_torch.utils.profiling import StepTimer

    device = torch.device("cpu" if args.cpu else "cuda")
    side = int(math.isqrt(args.n))
    state = bt.init_grid(side, side, 0.04, device)
    params = bt.FluidParams.demo()
    cfg = bt.IntegrateConfig.create()  # x in [-5, 3], bounce=-3
    grid = grid_solver.default_grid(0.045, -5.0, 3.0, y_max=4.0, cap=8)
    vgrid = verlet_solver.default_grid(0.045, -5.0, 3.0, y_max=4.0, cap=8)
    spec = raster.RasterSpec.fit(-5.0, 3.0, 0.0, 4.0, width=args.width)

    def advance(s):
        if args.solver == "golden":
            return golden.multi_step(s, params, cfg, args.substeps)
        if args.solver == "xla":
            return grid_solver.multi_step(s, params, cfg, grid,
                                          args.substeps)[0]
        if args.solver == "verlet":
            return verlet_solver.multi_step(s, params, cfg, vgrid,
                                            args.substeps)[0]
        return cuda_solver.multi_step(s, params, cfg, grid,
                                      args.substeps)[0]

    os.makedirs(args.out, exist_ok=True)
    sink = (FrameSink(args.out, width=spec.width, height=spec.height)
            if args.sink == "native" else None)
    pump = FramePump(pull=True)
    published = 0
    dropped = 0

    def publish(img) -> None:
        nonlocal published, dropped
        if img is None:
            return
        if sink is not None:
            dropped += 0 if sink.push(img) else 1
        else:
            write_ppm(os.path.join(args.out, f"frame_{published:06d}.ppm"),
                      img)
        published += 1

    timer = StepTimer(state.n)
    try:
        with timer.measure(args.frames * args.substeps):
            for i in range(args.frames):
                if i == args.kick_frame:
                    # scripted drag: push fluid up-right near the centre
                    state = apply_impulse(state, 1.0, 0.3, 0.6, 0.45)
                state = advance(state)
                publish(pump.push(raster.to_rgb8(
                    raster.render(state, params, spec, args.mode))))
            publish(pump.flush())
    finally:
        if sink is not None:
            sink.close()       # drains the ring: every queued frame written
    written = sink.written if sink is not None else published
    return dict(n=state.n, frames=args.frames, substeps=args.substeps,
                seconds=timer.seconds, fps=args.frames / timer.seconds,
                dropped=dropped, written=written,
                device=(torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
                solver=args.solver, sink=args.sink, out=args.out)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    print(f"{r['frames']} frames x {r['substeps']} steps of {r['n']} "
          f"particles in {r['seconds']:.2f}s ({r['fps']:.1f} fps incl. the "
          f"first frame; device={r['device']}, solver={r['solver']}, "
          f"sink={r['sink']}, written={r['written']}, "
          f"dropped={r['dropped']})")
    print(f"frames written to {r['out']}/frame_*.ppm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
