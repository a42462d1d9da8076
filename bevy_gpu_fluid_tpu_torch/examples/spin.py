"""Smoke-test scene: a rigid particle block spinning through the raster
pipeline, no fluid dynamics (port of ``examples/spin.py``).

The block is rotated and rendered on the card in the constant-colour mode
(the reference's SolidColor material), and the frames stream to the host
through ``render.pump.FramePump`` into the native ``FrameSink``.

    python -m bevy_gpu_fluid_tpu_torch.examples.spin --frames 48 --out spin
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bgf_torch_spin_frames"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; the default is the CUDA card")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    import torch

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.native import FrameSink
    from bevy_gpu_fluid_tpu_torch.render import raster
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump

    device = torch.device("cpu" if args.cpu else "cuda")
    base = bt.init_grid(24, 24, 0.04, device)
    params = bt.FluidParams.demo()
    cx = float(base.x.mean())
    cy = float(base.y.mean())
    spec = raster.RasterSpec.fit(cx - 1.2, cx + 1.2, cy - 1.2, cy + 1.2,
                                 width=256)

    def frame(theta: float):
        t = torch.tensor(theta, dtype=torch.float32, device=device)
        c, s = torch.cos(t), torch.sin(t)
        x = cx + (base.x - cx) * c - (base.y - cy) * s
        y = cy + (base.x - cx) * s + (base.y - cy) * c
        state = base.replace(x=x, y=y)
        return raster.to_rgb8(raster.render(state, params, spec, "const"))

    pump = FramePump(pull=True)
    dropped = 0
    with FrameSink(args.out, width=spec.width, height=spec.height) as sink:
        for i in range(args.frames + 1):
            img = (pump.push(frame(2 * math.pi * i / args.frames))
                   if i < args.frames else pump.flush())
            if img is not None:
                dropped += 0 if sink.push(img) else 1
    return dict(frames=args.frames, written=sink.written, dropped=dropped,
                out=args.out)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    print(f"{r['frames']} spin frames -> {r['out']} (written {r['written']}, "
          f"dropped {r['dropped']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
