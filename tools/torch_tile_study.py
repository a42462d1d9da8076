"""The tiled CUDA kernels K1 (density), K2 (forces + integrate), K8 (forces
alone), K5 (mono step), K4 (field raster) and K6 (select), the
TMA-ring experiments T1 (K2 staged ahead) and T3 (K8 on slot-major
planes) and the walk-tile experiments T2 (K1 on slot-major planes) and T4
(K8's arithmetic variants, v0 timed), against variants of their design, on
one NVIDIA GPU: K1, K2, K8, K4 (P = 2 and 5), K6 (int32 codes), T1-T4 at
the 1M-particle Session's planes (bench.py's dam break after 300 steps, as
chip_smoke.py phase 3), K5 at the 10k grid of ``bench.py --fps`` after 100
steps (as chip_smoke.py phase 8).

    python3 tools/torch_tile_study.py [variant ...]     # default: all

The planes come from one run of the committed kernels (saved under
``bevy_gpu_fluid_tpu_torch/_build/tile_study/``, the build directory, not
committed), so every variant is timed on the same inputs.  Each variant is
the port's ``csrc/`` with the source edits listed in ``VARIANTS``, built in
its own copy of the package there and run in its own process.  It prints,
per variant: each kernel's device time (torch.profiler, 50 calls), their
registers, shared memory and blocks per SM, and, for the variants that
compute the same function, K1's max relative error against its twin on
every slot and whether K2, K8, K5, K4 and K6 match their twins (K2 and
K5: positions 1e-5, velocities 1e-4 of max |v|, dead slots bitwise; K5
rho 1e-5 relative on live slots; K8 and T3 1e-5 of max |a|, dead slots
+0; K4 1e-5 relative on wet pixels; K6 bitwise; T1 bitwise K2; T2
bitwise K1 after ``movedim``; T4 v0 bitwise K8).
K4 runs its thread-per-cell kernel for P <= 4 and its halo-tile kernel
for larger P: the ``field_*`` tile variants move only the P = 5 reading,
and ``field_tile_only`` runs the tile kernel at every P.
``no_taps`` and ``no_dead`` (and ``field_no_taps``, ``select_no_scan``,
``select_no_write``) drop work and are timings only: what the tap
loops and the dead-slot passes cost (``no_taps`` drops T1's to T4's taps
too: T1 taps through ``bgf::tile_accel``, T2 and T4 v0 through
``bgf::walk_taps``).  ``t1_r2`` gives T1 2-row
tiles at four blocks per SM (it spills at the 80 registers that leaves),
``t1_r2_u1`` the same with its slot loops not unrolled (no spill),
``t3_r4`` T3 4-row tiles at two blocks, and ``tma_tile`` both a block
per tile in place of their persistent walk.  The walk tile's A/B (T2 and
T4, ``csrc/bgf_walk.cuh``): ``one_slot`` gives both back K1's and K8's
thread per slot on the new tile and staging (the old loop: one slot a
thread, every candidate below the largest of the 9 counts; the committed
kernels take two slots of one cell a thread over the same candidates);
``walk_r2`` 2 x 28-cell tiles (window stride 5), ``t4_128_threads``,
``t4_5_blocks`` (T4 built for five blocks per SM) and ``t2_256_threads``
other block shapes. ``skip_far_taps`` (a
branch per candidate past its cell's count) is K1's alone: K2's, K8's and
K5's force taps share ``bgf::tile_accel``, which loops to the largest
count. The variants run in turns, ``--rounds`` times (2 by default), and
the last line is one JSON object with every reading.
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
_SKIP = ("        for (int dy = 0; dy < 3; ++dy)\n"
         "          if (kj < cnt[(tr + dy) * kWinCols + tc + dx]) {\n")
_TAPS = "  for (int kj = 0; kj < kb; ++kj) {"
_DEAD = "    if (s >= cnt[(tr + "
_STENCIL = ("density.cu", "forces_integrate.cu", "forces.cu", "mono_step.cu")
_K4_TAPS = ("      for (int kj = 0; kj < kb; ++kj) {\n#pragma unroll\n"
            "        for")                 # K4's halo-tile taps
_K6_WRITE = "  for_tile_slots<kBlock>(t, cap, [&](int tr, int s, int tc) {\n"
_GRID = "bgf::persistent_grid(\n        kMinBlocks,"   # T1's and T3's
_ONCE = "#pragma unroll 1\n"    # t1_r2_u1: T1's slot loops not unrolled
_T1_BOXES = ("      for (int j = 0; j < kmax; ++j) {\n"
             "        for (int f = 0; f < kWinFields")
_T1_REFS = "      for (int s = 0; s < kmax; ++s) {\n        // the box"
_REPACK = "    for (int kj = 0; kj < kmax; ++kj) {\n      const int i = (wr"
_T3_TAPS = ("      for (int kj = 0; kj < kb; ++kj) {\n#pragma unroll\n"
            "        for (int dy")            # T3's taps, (kj, dy, dx)
_WALKS = ("exp_forces.cu", "exp_tlayout.cu")

# variant -> [(file under csrc/, text, replacement)]
VARIANTS = {
    "tiled": [],                                   # the committed design
    "tile_2x30": [("bgf_common.cuh", "kTileRows = 4;", "kTileRows = 2;")],
    "tile_8x30": [("bgf_common.cuh", "kTileRows = 4;", "kTileRows = 8;")],
    "k1_256_threads": [("density.cu", "kBlock = 128;", "kBlock = 256;")],
    "k8_128_threads": [("forces.cu", "kBlock = bgf::kThreads;",
                        "kBlock = 128;")],
    "mono_1x28": [("mono_step.cu", "kMonoRows = 2;", "kMonoRows = 1;")],
    "mono_4x28": [("mono_step.cu", "kMonoRows = 2;", "kMonoRows = 4;")],
    "mono_8x28": [("mono_step.cu", "kMonoRows = 2;", "kMonoRows = 8;")],
    "field_2x30": [("field.cu", "kFieldRows = 4;", "kFieldRows = 2;")],
    "field_8x30": [("field.cu", "kFieldRows = 4;", "kFieldRows = 8;")],
    "field_256_threads": [("field.cu", "kBlock = 128;", "kBlock = 256;")],
    "field_tile_only": [("field.cu", "kCellP = 4;", "kCellP = 0;")],
    "field_8x30_256": [("field.cu", "kFieldRows = 4;", "kFieldRows = 8;"),
                       ("field.cu", "kBlock = 128;", "kBlock = 256;")],
    "field_no_taps": [("field.cu", _K4_TAPS, _K4_TAPS.replace("kj < kb",
                                                              "kj < 0"))],
    "select_no_scan": [("select.cu", _TAPS, _TAPS.replace("kj < kb",
                                                          "kj < 0"))],
    "select_no_write": [("select.cu", _K6_WRITE, "  if (false)\n" + _K6_WRITE)],
    "select_2x30": [("select.cu", "kSelectRows = 4;", "kSelectRows = 2;")],
    "select_8x30": [("select.cu", "kSelectRows = 4;", "kSelectRows = 8;")],
    "select_256_threads": [("select.cu", "kBlock = 128;", "kBlock = 256;")],
    "skip_far_taps": [           # a branch per candidate past its count
        ("density.cu", _K1_TAP, _SKIP + "          const float2 w")],
    "no_taps": [(f, _TAPS, _TAPS.replace("kj < kb", "kj < 0"))
                for f in ("density.cu", "bgf_common.cuh", "mono_step.cu",
                          "bgf_walk.cuh")]
    + [("exp_tlayout.cu", _T3_TAPS, _T3_TAPS.replace("kj < kb", "kj < 0"))],
    "no_dead": [(f, _DEAD, _DEAD.replace("if (", "if (false && "))
                for f in _STENCIL],
    # T1 at 2-row tiles, four blocks per SM of 5 consumer warps; T3 at
    # 4-row tiles, two blocks of 11; both a block per tile in place of
    # the persistent walk
    "t1_r2": [("exp_dbuf.cu", "kRows = 4;", "kRows = 2;"),
              ("exp_dbuf.cu", "kWarps = 11;", "kWarps = 5;"),
              ("exp_dbuf.cu", "kMinBlocks = 2;", "kMinBlocks = 4;")],
    "t1_r2_u1": [("exp_dbuf.cu", "kRows = 4;", "kRows = 2;"),
                 ("exp_dbuf.cu", "kWarps = 11;", "kWarps = 5;"),
                 ("exp_dbuf.cu", "kMinBlocks = 2;", "kMinBlocks = 4;"),
                 ("exp_dbuf.cu", _T1_BOXES, _ONCE + _T1_BOXES),
                 ("exp_dbuf.cu", _T1_REFS, _ONCE + _T1_REFS),
                 ("bgf_tma.cuh", _REPACK, _ONCE + _REPACK)],
    "t3_r4": [("exp_tlayout.cu", "kRows = 2;", "kRows = 4;"),
              ("exp_tlayout.cu", "kWarps = 6;", "kWarps = 11;"),
              ("exp_tlayout.cu", "kMinBlocks = 4;", "kMinBlocks = 2;")],
    "tma_tile": [(f, _GRID, _GRID.replace("kMinBlocks,", "1 << 16,"))
                 for f in ("exp_dbuf.cu", "exp_tlayout.cu")],
    # the walk tile's A/B (T2 and T4): one slot a thread (K1's and K8's
    # loop); other block shapes
    "one_slot": [("exp_forces.cu", "kSlots = 2;", "kSlots = 1;"),
                 ("exp_tlayout.cu", "kDensitySlots = 2;",
                  "kDensitySlots = 1;")],
    "walk_r2": [(f, "WalkTile<4, 7>", "WalkTile<2, 5>") for f in _WALKS],
    "t4_128_threads": [("exp_forces.cu", "kBlock = 256;", "kBlock = 128;")],
    "t4_5_blocks": [("exp_forces.cu", "__launch_bounds__(kBlock)",
                     "__launch_bounds__(kBlock, 5)")],
    "t2_256_threads": [("exp_tlayout.cu", "kDensityBlock = 128;",
                        "kDensityBlock = 256;")],
}
TIMING_ONLY = ("no_taps", "no_dead", "field_no_taps", "select_no_scan",
               "select_no_write")

# the scene, shared by the planes run and every variant
SCENE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.kernels import _build
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.render import raster
assert bt.__file__.startswith(sys.argv[1]), bt.__file__
dev = torch.device("cuda")
params = bt.FluidParams.demo()
cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=41.0)
grid = vs.default_grid(0.045, -1.0, 41.0, y_max=45.0)
cfg10k = bt.IntegrateConfig.create(x_min=-1.0, x_max=5.0)      # 100 x 100
grid10k = vs.default_grid(0.045, -1.0, 5.0, y_max=4.0 * 1.1 + 1.0)
FIELDS = ("xd", "yd", "vxd", "vyd", "ref_xd", "ref_yd", "occ")
'''

# the 1M Session (300 steps) and the 10k one (100 steps, on K5) on the
# committed kernels, their planes saved
PLANES = SCENE + r'''
sess = vs.Session(bt.init_grid(1000, 1000, 0.04, dev), params, cfg, grid,
                  device=dev)
sess.run(300)
small = vs.Session(bt.init_grid(100, 100, 0.04, dev), params, cfg10k,
                   grid10k, device=dev)
small.run(100)
torch.save({"1m": {f: getattr(sess.sim, f) for f in FIELDS},
            "10k": {f: getattr(small.sim, f) for f in FIELDS}}, sys.argv[2])
'''

CHILD = SCENE + r'''
from types import SimpleNamespace
from torch.profiler import ProfilerActivity, profile
saved = torch.load(sys.argv[2])
s = SimpleNamespace(**saved["1m"])
m = SimpleNamespace(**saved["10k"])

def device_ms(fn, name, reps=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.device_time_total for e in prof.key_averages()
            if name in e.key][0] / 1e3 / reps

def bits(t):
    return t.contiguous().view(torch.int32)

def step_ok(got, want, dead):
    """positions 1e-5, velocities 1e-4 of max |v|, dead slots bitwise"""
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    return bool(max(float((g - w).abs().max())
                    for g, w in zip(got[:2], want[:2])) <= 1e-5
                and max(float((g - w).abs().max())
                        for g, w in zip(got[2:4], want[2:4]))
                <= 1e-4 * vscale
                and all(torch.equal(bits(g[dead]), bits(w[dead]))
                        for g, w in zip(got, want)))

k1 = lambda: cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
rho = cuda_solver.density_torch(s.xd, s.yd, params, grid, s.occ)
args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, params, cfg,
        grid, s.occ)
k2 = lambda: cuda_solver.forces_integrate_cuda(*args)
f8 = (s.xd, s.yd, s.vxd, s.vyd, rho, params, grid, s.occ)
k8 = lambda: cuda_solver.forces_cuda(*f8)
margs = (m.xd, m.yd, m.vxd, m.vyd, m.ref_xd, m.ref_yd, params, cfg10k,
         grid10k, m.occ)
k5 = lambda: cuda_solver.mono_step_cuda(*margs)
got1, got2, got8, got5 = k1(), k2(), k8(), k5()
dead = s.xd >= 5e8
want8 = cuda_solver.forces_torch(*f8)
want5 = cuda_solver.mono_step_torch(*margs)
mlive = m.xd < 5e8
a_scale = float(torch.maximum(want8[0].abs().max(), want8[1].abs().max()))
k4 = {P: (lambda P=P: raster.field_density_cuda(s.xd, s.yd, params, grid, P))
      for P in (2, 5)}

def field_rel(P):
    want = raster.field_density(s.xd, s.yd, params, grid, P)
    wet = want > 0.05 * float(params.rho_0)
    return float(((k4[P]() - want).abs() / want)[wet].max())

k6 = lambda: reslot.select_cuda(s.xd, s.yd, grid, s.occ)
want6 = reslot.select_torch(s.xd, s.yd, grid, s.occ)
from bevy_gpu_fluid_tpu_torch.models import exp_kernels as ek
t1 = lambda: ek.forces_integrate_dbuf_cuda(*args)
slot_major = [ek.to_slot_major(p) for p in (s.xd, s.yd, s.vxd, s.vyd, rho)]
t3 = lambda: ek.forces_t_cuda(*slot_major, params, grid,
                              ek.block_kmax3_t(slot_major[0], grid))
got_t3 = [ek.from_slot_major(a) for a in t3()]
t2 = lambda: ek.density_t_cuda(slot_major[0], slot_major[1], params, grid,
                               ek.block_kmax3_t(slot_major[0], grid))
t4 = lambda: ek.forces_variant_cuda(*f8, "v0")
print(json.dumps(dict(
    k1_ms=device_ms(k1, "density_kernel"),
    k2_ms=device_ms(k2, "forces_integrate_kernel"),
    k8_ms=device_ms(k8, "forces_kernel"),
    k5_ms=device_ms(k5, "mono_step_kernel"),
    k4_ms=device_ms(k4[2], "field_"),
    k4p5_ms=device_ms(k4[5], "field_"),
    k6_ms=device_ms(k6, "select_kernel"),
    t1_ms=device_ms(t1, "dbuf_kernel"),
    t3_ms=device_ms(t3, "forces_t_kernel"),
    t2_ms=device_ms(t2, "density_t_kernel"),
    t4_ms=device_ms(t4, "forces_variant_kernel"),
    k1_rel=float(((got1 - rho).abs() / rho.abs().clamp_min(1e-30)).max()),
    k2_ok=step_ok(got2[:4], cuda_solver.forces_integrate_torch(*args)[:4],
                  dead),
    k8_ok=bool(max(float((g - w).abs().max()) for g, w in zip(got8, want8))
               <= 1e-5 * a_scale
               and all(bool((bits(g[dead]) == 0).all()) for g in got8)),
    k5_ok=step_ok(got5[:5], want5[:5], ~mlive)
          and float(((got5[4] - want5[4]).abs() / want5[4])[mlive].max())
          <= 1e-5,
    k4_ok=max(field_rel(2), field_rel(5)) <= 1e-5,
    k6_ok=all(torch.equal(g, w) for g, w in zip(k6(), want6)),
    t1_ok=all(torch.equal(bits(g), bits(w)) for g, w in zip(t1(), got2)),
    t2_ok=torch.equal(bits(ek.from_slot_major(t2())), bits(got1)),
    t4_ok=all(torch.equal(bits(g), bits(w)) for g, w in zip(t4(), got8)),
    t3_ok=bool(max(float((g - w).abs().max()) for g, w in zip(got_t3, want8))
               <= 1e-5 * a_scale
               and all(bool((bits(g[dead]) == 0).all()) for g in got_t3)),
    occupancy=dict({n: _build.occupancy(n, grid.cap)
                    for n in ("density", "forces_integrate", "forces",
                              "mono_step", "field", "select")},
                   dbuf=_build.occupancy("forces_integrate_dbuf", grid.cap),
                   forces_t=_build.occupancy("forces_t", grid.cap),
                   density_t=_build.occupancy("density_t", grid.cap),
                   forces_variant=_build.occupancy("forces_variant",
                                                   grid.cap, 0)))))
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
            ok = all(r[k] for k in ("k2_ok", "k8_ok", "k5_ok", "k4_ok",
                                    "k6_ok", "t1_ok", "t2_ok", "t3_ok",
                                    "t4_ok")) \
                and r["k1_rel"] <= 1e-5
            check = ("timing only" if v in TIMING_ONLY else
                     f"K1 rel {r['k1_rel']:.1e}, K2 / K8 / K5 / K4 / K6 / "
                     f"T1 / T2 / T3 / T4 match {r['k2_ok']} / "
                     f"{r['k8_ok']} / {r['k5_ok']} / {r['k4_ok']} / "
                     f"{r['k6_ok']} / {r['t1_ok']} / {r['t2_ok']} / "
                     f"{r['t3_ok']} / {r['t4_ok']}")
            print(f"{v}: K1 {r['k1_ms']:.4f} ms, K2 {r['k2_ms']:.4f} ms, "
                  f"K8 {r['k8_ms']:.4f} ms, K4 {r['k4_ms']:.4f} ms (P = 2; "
                  f"P = 5 {r['k4p5_ms']:.4f}), K6 {r['k6_ms']:.4f} ms, T1 "
                  f"{r['t1_ms']:.4f} ms, T2 {r['t2_ms']:.4f} ms, T3 "
                  f"{r['t3_ms']:.4f} ms, T4 v0 {r['t4_ms']:.4f} ms "
                  f"(1M planes), "
                  f"K5 {r['k5_ms']:.4f} ms (10k); {check}; (registers, "
                  f"shared bytes, blocks/SM, spill) {occ}", flush=True)
            if v not in TIMING_ONLY and not ok:
                raise RuntimeError(f"{v} disagrees with the twins")
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
