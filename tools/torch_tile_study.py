"""The tiled K1 (density) and K2 (forces + integrate) CUDA kernels against
variants of their design, on one NVIDIA GPU, at the 1M-particle Session's
planes (bench.py's dam break after 300 steps, as chip_smoke.py phase 3).

    python3 tools/torch_tile_study.py [variant ...]     # default: all

The planes come from one run of the committed kernels (300 steps, saved
under ``bevy_gpu_fluid_tpu_torch/_build/tile_study/``, the build
directory, not committed), so every variant is timed on the same inputs.
Each variant is the port's ``csrc/`` with the source edits listed in
``VARIANTS``, built in its own copy of the package there and run in its
own process.  It prints, per variant: K1's and
K2's device time (torch.profiler, 50 calls), their registers, shared memory
and blocks per SM, and, for the variants that compute the same function,
K1's max relative error against its twin on every slot and whether K2
matches its twin (positions 1e-5, velocities 1e-4 of max |v|, dead slots
bitwise).  ``no_taps`` and ``no_dead`` drop work and are timings only:
what the tap loop and the dead-slot pass cost.  The variants run in turns,
``--rounds`` times (2 by default), and the last line is one JSON object
with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bevy_gpu_fluid_tpu_torch")
STUDY = os.path.join(PKG, "_build", "tile_study")

_K1_TAP = ("        for (int dy = 0; dy < 3; ++dy) {\n"
           "          const float2 w")
_K2_TAP = ("        for (int dy = 0; dy < 3; ++dy) {\n"
           "          const int j")
_SKIP = ("        for (int dy = 0; dy < 3; ++dy)\n"
         "          if (kj < cnt[(tr + dy) * kWinCols + tc + dx]) {\n")
_TAPS = "    for (int kj = 0; kj < kb; ++kj) {"
_DEAD = "    if (s >= cnt[(tr + 1) * kWinCols + tc + 1])"

# variant -> [(file under csrc/, text, replacement)]
VARIANTS = {
    "tiled": [],                                   # the committed design
    "tile_2x30": [("bgf_common.cuh", "kTileRows = 4;", "kTileRows = 2;")],
    "tile_8x30": [("bgf_common.cuh", "kTileRows = 4;", "kTileRows = 8;")],
    "k1_256_threads": [("density.cu", "kBlock = 128;", "kBlock = 256;")],
    "skip_far_taps": [           # a branch per candidate past its count
        ("density.cu", _K1_TAP, _SKIP + "          const float2 w"),
        ("forces_integrate.cu", _K2_TAP, _SKIP + "          const int j")],
    "no_taps": [(f, _TAPS, _TAPS.replace("kj < kb", "kj < 0"))
                for f in ("density.cu", "forces_integrate.cu")],
    "no_dead": [(f, _DEAD, _DEAD.replace("if (", "if (false && "))
                for f in ("density.cu", "forces_integrate.cu")],
}
TIMING_ONLY = ("no_taps", "no_dead")

# the scene, shared by the planes run and every variant
SCENE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.kernels import _build
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
assert bt.__file__.startswith(sys.argv[1]), bt.__file__
dev = torch.device("cuda")
params = bt.FluidParams.demo()
cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=41.0)
grid = vs.default_grid(0.045, -1.0, 41.0, y_max=45.0)
FIELDS = ("xd", "yd", "vxd", "vyd", "ref_xd", "ref_yd", "occ")
'''

# the 1M Session on the committed kernels, 300 steps, its planes saved
PLANES = SCENE + r'''
sess = vs.Session(bt.init_grid(1000, 1000, 0.04, dev), params, cfg, grid,
                  device=dev)
sess.run(300)
torch.save({f: getattr(sess.sim, f) for f in FIELDS}, sys.argv[2])
'''

CHILD = SCENE + r'''
from types import SimpleNamespace
from torch.profiler import ProfilerActivity, profile
s = SimpleNamespace(**torch.load(sys.argv[2]))

def device_ms(fn, name, reps=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.device_time_total for e in prof.key_averages()
            if name in e.key][0] / 1e3 / reps

k1 = lambda: cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
rho = cuda_solver.density_torch(s.xd, s.yd, params, grid, s.occ)
args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, params, cfg,
        grid, s.occ)
k2 = lambda: cuda_solver.forces_integrate_cuda(*args)
got1, got2 = k1(), k2()
want2 = cuda_solver.forces_integrate_torch(*args)
dead = s.xd >= 5e8
vscale = float(torch.maximum(want2[2].abs().max(), want2[3].abs().max()))
print(json.dumps(dict(
    k1_ms=device_ms(k1, "density_kernel"),
    k2_ms=device_ms(k2, "forces_integrate_kernel"),
    k1_rel=float(((got1 - rho).abs() / rho.abs().clamp_min(1e-30)).max()),
    k2_ok=bool(max(float((g - w).abs().max())
                   for g, w in zip(got2[:2], want2[:2])) <= 1e-5
               and max(float((g - w).abs().max())
                       for g, w in zip(got2[2:4], want2[2:4]))
               <= 1e-4 * vscale
               and all(torch.equal(g[dead], w[dead])
                       for g, w in zip(got2[:4], want2[:4]))),
    occupancy={n: _build.occupancy(n, grid.cap)
               for n in ("density", "forces_integrate")})))
'''


def make_variant(name: str) -> str:
    """A copy of the package with the variant's edits; returns its root."""
    root = os.path.join(STUDY, name)
    shutil.rmtree(root, ignore_errors=True)
    dst = os.path.join(root, "bevy_gpu_fluid_tpu_torch")
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(dst, "csrc", fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {fname} does not hold {old!r} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    roots = {v: make_variant(v) for v in a.variants}
    planes = os.path.join(STUDY, "planes.pt")
    subprocess.run([sys.executable, "-c", PLANES, ROOT, planes], check=True,
                   timeout=900)
    runs = {v: [] for v in a.variants}
    for _ in range(a.rounds):
        for v in a.variants:
            out = subprocess.run(
                [sys.executable, "-c", CHILD, roots[v], planes],
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"{v} failed:\n{out.stderr[-4000:]}")
            r = json.loads(out.stdout.strip().splitlines()[-1])
            runs[v].append(r)
            occ = {n: (o["registers"], o["dynamic_smem"], o["blocks_per_sm"],
                       o["local_bytes"]) for n, o in r["occupancy"].items()}
            check = ("timing only" if v in TIMING_ONLY else
                     f"K1 rel {r['k1_rel']:.1e}, K2 matches {r['k2_ok']}")
            print(f"{v}: K1 {r['k1_ms']:.4f} ms, K2 {r['k2_ms']:.4f} ms; "
                  f"{check}; (registers, shared bytes, blocks/SM, spill) "
                  f"{occ}", flush=True)
            if v not in TIMING_ONLY and (r["k1_rel"] > 1e-5
                                         or not r["k2_ok"]):
                raise RuntimeError(f"{v} disagrees with the twins")
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
