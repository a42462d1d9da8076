"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_gpu_fluid_tpu_torch/csrc`` and
drives its paths — the Verlet ``Session`` on the 1M-particle dam break of
``bench.py``, its field-frame loop, and the ``bench.py --fps`` plan through
the ``Simulation`` facade — then checks them:

1. device and ``nvidia-smi`` name / power limit;
2. kernel build (one nvcc per source in parallel, sm_90a), with its time;
3. after 300 steps: each step kernel (K1 density, K2 forces+integrate, K3
   reslot) against its PyTorch twin on the Session's own planes; the
   kernel timed alone (torch.profiler device time), its wrapper and its
   twin with CUDA events; its bound (bytes or float32 operations of this
   run's inputs over the H100's peak rates);
4. the main path: 600 more steps, with every launch counter zeroed first;
   fields finite, no overflow or loss, at least 2 rebins, K1/K2 launched
   once per step, K3 once per rebin, K5 never (85 row blocks); ms/step and
   particle-steps/s;
5. overflow recovery (9 particles in one cell at cap 8; a 7-row-block grid,
   so it steps on K5);
6. parity with the port's golden model on the 5,041-particle scene at the
   reference bars (also K5);
7. K4 (field raster, P = 2) on the 1M planes against its twin, timed; then
   the frame path: ``Session.run_frame(16)`` through ``FramePump(pull=
   False)`` and ``FramePump(pull=True)``, counters zeroed first, K4 once
   per frame; ms/frame;
8. K5 (mono step) on the three ``--fps`` grids (10k, 5,041, 1,024
   particles) after 100 steps, against its twin on every slot and against
   K1 + K2 on live slots; K5 timed against K1 + K2 per grid, device time
   and per step call in turns (the mono threshold, measured on the card);
9. the ``--fps`` plan through ``Simulation``: 16 substeps per frame, splat
   per frame and batched x32, field batched x32, each with the pump on
   the device and pulled to the host; counters zeroed first: K5 once per
   step, K1/K2 never, K4 once per field frame; overflow 0, frames not
   black; ``run_frames(4)`` bitwise equal to 4 ``run_frame`` calls; FPS.

Every phase raises on failure.  The last lines are the kernel table (JSON),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script fails before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SIDE = 1000          # bench.py's 1M scene: 1000 x 1000 at spacing 0.04
WARM_STEPS = 300
MAIN_STEPS = 600
FIELD_P = 2            # field raster subpixels per cell side
FRAME_SUBSTEPS = 16    # sim steps per frame (real time at dt = 5e-4, 60 Hz)
FRAMES_1M = 12         # frames per pump mode on the 1M Session
FPS_PLAN = (10_000, 5_041, 1_024)   # bench.py --fps
FPS_FRAMES = 48        # per-frame cases
FPS_BATCH = 32         # batched cases: FPS_BATCHES batches of 32 frames
FPS_BATCHES = 3
MONO_STEPS = 100       # warm-up steps before the K5 comparison

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes and float32
# operations outside the tensor cores, per millisecond.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3
# float32 operations per pair tap that the functions need (each add, sub,
# mul, max, div or rsqrt counts one):
DENSITY_OPS = 10   # 2 differences, r^2 (3), h^2 - r^2, max, d^3 (2), sum
FORCE_OPS = 29     # K2's pair terms, with p and 1/rho taken once per slot
RESLOT_OPS = 13    # live test, two clipped cell coordinates (5 each), match


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels, reps: int) -> dict:
    """Mean device milliseconds per call of ``fn`` of each CUDA kernel
    named in ``kernels``, from torch.profiler's device trace: the kernels
    alone, without the wrapper's host work and other launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for kernel in kernels:
        us = [getattr(e, "device_time_total", 0) or e.cuda_time_total
              for e in prof.key_averages() if kernel in e.key]
        check(len(us) == 1 and us[0] > 0,
              f"profiler shows no device time for {kernel}")
        out[kernel] = us[0] / 1e3 / reps
    return out


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """``device_ms`` of one kernel that ``fn`` launches once per call."""
    return device_ms(fn, [kernel], reps)[kernel]


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    tb, to = n_bytes / HBM_BYTES_PER_MS, n_ops / F32_OPS_PER_MS
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bound_bytes=n_bytes, bound_ops=n_ops)


def row_bounds(per_block, grid):
    """Per-row slot bounds [ny_pad] from per-row-block ones [nb] (0 on the
    ghost blocks)."""
    tb = grid.row_block
    km = torch.zeros(grid.ny_pad, dtype=torch.int64, device=per_block.device)
    km[tb:tb + grid.n_row_blocks * tb] = per_block.to(
        torch.int64).repeat_interleave(tb)
    return km


def live_taps(xd, per_block, grid) -> float:
    """Pair taps the live slots need: each live slot x 9 neighbour cells x
    its row block's slot bound."""
    live = (xd < 5e8).sum(dim=(1, 2))
    return 9.0 * float((live * row_bounds(per_block, grid)).sum())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the GPU")
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.kernels import _build
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.models import reference as golden
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.ops import reslot
    from bevy_gpu_fluid_tpu_torch.render import raster
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    print(f"# phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi: {card}", flush=True)

    # ---- phase 2: build --------------------------------------------------
    lib, build_s, log = _build.build()
    print(f"# phase 2: built {lib.parent.name}/{lib.name} in {build_s:.1f} s "
          f"(0 = reused)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"#   ptxas: {line.strip()}")
    _build.load()

    # ---- phase 3: kernels vs twins on the 1M Session's planes ------------
    params = bt.FluidParams.demo()
    extent = N_SIDE * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0)
    grid = vs.default_grid(0.045, -1.0, extent + 1.0,
                           y_max=extent * 1.1 + 1.0)
    check((grid.ny_pad, grid.cap, grid.nx_pad) == (696, 8, 640),
          f"1M grid shape {grid.plane_shape}")
    check(grid.n_row_blocks >= cuda_solver.MONO_MAX_BLOCKS,
          "the 1M grid should step on K1 + K2")
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    t0 = time.perf_counter()
    sess = vs.Session(state, params, cfg, grid, device=dev)
    sess.run(WARM_STEPS)
    torch.cuda.synchronize()
    print(f"# phase 3: {sess.n} particles, grid {grid.plane_shape}, "
          f"init + {WARM_STEPS} steps {time.perf_counter() - t0:.2f} s, "
          f"rebins {sess.sim.rebin_count - 1}", flush=True)
    s = sess.sim
    live = s.xd < 5e8
    plane_b = 4.0 * s.xd.numel()
    occ_b = 4.0 * s.occ.numel()
    kmax_blocks = s.occ.amax(dim=0)
    taps = live_taps(s.xd, kmax_blocks, grid)
    kernels = []

    k1 = lambda: cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
    t1 = lambda: cuda_solver.density_torch(s.xd, s.yd, params, grid, s.occ)
    rho_k, rho_t = k1(), t1()
    rel = float(((rho_k - rho_t).abs() / rho_t.abs())[live].max())
    print(f"#   K1 density: max rel err on live slots {rel:.3e} (<= 1e-5)")
    check(rel <= 1e-5, f"K1 density rel err {rel}")
    kernels.append(dict(
        name="density", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/density.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:224",
        max_abs_err=float((rho_k - rho_t)[live].abs().max()),
        ms=kernel_ms(k1, "density_kernel", 50), wrapper_ms=cuda_ms(k1, 50),
        plain_ms=cuda_ms(t1, 3), library_ms=None,
        **bound(3 * plane_b + occ_b, taps * DENSITY_OPS)))

    fargs = (s.xd, s.yd, s.vxd, s.vyd, rho_k, s.ref_xd, s.ref_yd, params,
             cfg, grid, s.occ)
    k2 = lambda: cuda_solver.forces_integrate_cuda(*fargs)
    t2 = lambda: cuda_solver.forces_integrate_torch(*fargs)
    got, want = k2(), t2()
    pos_err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    vel_err = max(float((g - w).abs().max())
                  for g, w in zip(got[2:4], want[2:4]))
    d_err = abs(float(got[4]) - float(want[4]))
    print(f"#   K2 forces+integrate: |dx| {pos_err:.3e} (<= 1e-5), |dv| "
          f"{vel_err:.3e} of max|v| {vscale:.3f} (<= 1e-4 rel), disp2 "
          f"{float(got[4]):.6e} vs {float(want[4]):.6e}")
    check(pos_err <= 1e-5, f"K2 position err {pos_err}")
    check(vel_err <= 1e-4 * vscale, f"K2 velocity err {vel_err}")
    check(d_err <= 1e-4 * float(want[4]), f"K2 disp2 err {d_err}")
    n_live = float(live.sum())
    kernels.append(dict(
        name="forces_integrate", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:400",
        max_abs_err=max(pos_err, vel_err, d_err),
        ms=kernel_ms(k2, "forces_integrate_kernel", 50),
        wrapper_ms=cuda_ms(k2, 50), plain_ms=cuda_ms(t2, 3), library_ms=None,
        **bound(11 * plane_b + occ_b + 4,
                taps * FORCE_OPS + n_live * 20)))   # EOS + integrate: ~20

    planes = (s.xd, s.yd, s.vxd, s.vyd, s.idx_d)
    k3 = lambda: reslot.reslot_cuda(*planes, grid)
    t3 = lambda: reslot.reslot_torch(*planes, grid)
    got, want = k3(), t3()
    for name, g, w in zip(("x", "y", "vx", "vy", "idx", "cnt"), got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"K3 reslot {name} not bitwise equal to its twin")
    print(f"#   K3 reslot: all six outputs bitwise equal; matched "
          f"{int(got[5].sum())} of {int(live.sum())} live slots")
    cand = 9.0 * grid.nx_pad * float(row_bounds(kmax_blocks, grid).sum())
    kernels.append(dict(
        name="reslot", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/reslot.cu",
        replaces="bevy_gpu_fluid_tpu/ops/reslot.py:203",
        max_abs_err=max(float((g.double() - w.double()).abs().max())
                        for g, w in zip(got, want)),
        ms=kernel_ms(k3, "reslot_kernel", 20), wrapper_ms=cuda_ms(k3, 20),
        plain_ms=cuda_ms(t3, 3), library_ms=None,
        **bound(10 * plane_b + occ_b + 4.0 * grid.ny_pad * grid.nx_pad,
                cand * RESLOT_OPS)))
    del got, want, rho_k, rho_t

    # ---- phase 4: the main path ------------------------------------------
    wrappers = {"density": cuda_solver.density_cuda,
                "forces_integrate": cuda_solver.forces_integrate_cuda,
                "reslot": reslot.reslot_cuda,
                "field_raster": raster.field_density_cuda,
                "mono_step": cuda_solver.mono_step_cuda}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    zero_counts()
    rebins0 = sess.sim.rebin_count
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sess.run(MAIN_STEPS)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    rebins = sess.sim.rebin_count - rebins0
    ms_step = start.elapsed_time(end) / MAIN_STEPS
    sim = sess.sim
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (sim.xd, sim.yd, sim.vxd, sim.vyd, sim.rho_d))
    print(f"# phase 4: {MAIN_STEPS} steps: {ms_step:.4f} ms/step (CUDA "
          f"events; host {wall / MAIN_STEPS * 1e3:.4f} ms/step) = "
          f"{sess.n / ms_step * 1e3 / 1e6:.1f}M particle-steps/s on {card}; "
          f"rebins {rebins}, overflow {sim.overflow}, lost {sim.lost}, "
          f"launches {launches}", flush=True)
    for k in kernels:
        print(f"#   {k['name']}: kernel {k['ms']:.4f} ms (profiler), wrapper "
              f"{k['wrapper_ms']:.4f} ms, twin {k['plain_ms']:.4f} ms (CUDA "
              f"events), bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bound_bytes'] / 1e6:.1f} MB, "
              f"{k['bound_ops'] / 1e9:.3f} GFLOP) per call at "
              f"{grid.plane_shape} on {card}")
    check(finite, "non-finite field after the main path")
    check(sim.overflow == 0 and sim.lost == 0,
          f"overflow {sim.overflow} lost {sim.lost}")
    check(rebins >= 2, f"only {rebins} rebins in the main path")
    check(launches["density"] == MAIN_STEPS
          and launches["forces_integrate"] == MAIN_STEPS,
          f"K1/K2 launches {launches} != {MAIN_STEPS} steps")
    check(launches["reslot"] == rebins,
          f"K3 launches {launches['reslot']} != {rebins} rebins")
    check(launches["mono_step"] == 0 and launches["field_raster"] == 0,
          f"K4/K5 launched on the 1M step path: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    out = sess.state()
    check(bool(torch.isfinite(out.x).all() & (out.x < 5e8).all()),
          "extracted state not finite")
    del s, sim, out, planes, fargs

    # ---- phase 5: overflow recovery --------------------------------------
    rcfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    rgrid = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    zero_counts()
    rsess = vs.Session(bt.init_grid(3, 3, 0.004, dev), params, rcfg, rgrid,
                       device=dev)
    over0 = rsess.overflow
    rsess.run(60)
    ids = torch.sort(torch.cat([rsess.sim.idx_d.reshape(-1),
                                rsess.sim.sidx])).values[-rsess.n:]
    print(f"# phase 5: recovery: overflow at init {over0}, readmitted "
          f"{rsess.readmitted}, suspended {rsess.suspended}, rebins "
          f"{rsess.sim.rebin_count - 1}, launches {counts()}", flush=True)
    check(over0 == 1, f"recovery scene overflow at init {over0}")
    check(rsess.readmitted >= 1, "recovery scene: nothing readmitted")
    check(torch.equal(ids.cpu(), torch.arange(rsess.n, dtype=torch.int32)),
          "recovery scene: ids are not exactly {0..n-1}")
    check(counts()["mono_step"] == 60 and counts()["density"] == 0,
          f"recovery scene (7 row blocks) did not step on K5: {counts()}")

    # ---- phase 6: parity with the golden model ---------------------------
    pstate, pparams = bt.demo_block_5k(dev)
    pcfg = bt.IntegrateConfig.create()
    pgrid = vs.default_grid(0.045, -5.0, 3.0, y_max=4.0)
    g = golden.multi_step(pstate, pparams, pcfg, 10)
    psess = vs.Session(pstate, pparams, pcfg, pgrid, device=dev)
    psess.run(10)
    a = psess.state()
    rho_rel = float(((a.rho - g.rho).abs() / g.rho).max())
    p_abs = float((a.p - g.p).abs().max())
    dx = max(float((a.x - g.x).abs().max()), float((a.y - g.y).abs().max()))
    dv = max(float((a.vx - g.vx).abs().max()),
             float((a.vy - g.vy).abs().max()))
    print(f"# phase 6: parity vs golden, 5,041 particles x 10 steps "
          f"({pgrid.n_row_blocks} row blocks, K5): rho {rho_rel:.3e} "
          f"(<= 3e-3), p {p_abs:.3e} (<= 30), |dx| {dx:.3e} (<= 5.18e-4), "
          f"|dv| {dv:.3e} (<= 0.2456)", flush=True)
    check(psess.overflow == 0, "parity scene overflowed")
    check(rho_rel <= 0.003 and p_abs <= 30.0, "parity: rho/p bars")
    check(dx <= 0.000518 and dv <= 0.245602, "parity: drift bars")

    # ---- phase 7: K4 and the frame path on the 1M Session ----------------
    s = sess.sim
    k4 = lambda: raster.field_density_cuda(s.xd, s.yd, params, grid, FIELD_P)
    t4 = lambda: raster.field_density(s.xd, s.yd, params, grid, FIELD_P)
    fk, ft = k4(), t4()
    wet = ft > 0.05 * float(params.rho_0)
    f_rel = float(((fk - ft).abs() / ft)[wet].max())
    print(f"# phase 7: K4 field raster P={FIELD_P} at {tuple(fk.shape)}: "
          f"max rel err on {int(wet.sum())} wet pixels {f_rel:.3e} "
          f"(<= 1e-5)", flush=True)
    check(f_rel <= 1e-5, f"K4 field rel err {f_rel}")
    check(tuple(fk.shape) == (grid.ny * FIELD_P, grid.nx * FIELD_P),
          f"field shape {tuple(fk.shape)}")
    occ_now = reslot.block_kmax3(s.xd, grid)
    real_rows = row_bounds(occ_now.amax(dim=0), grid)[
        grid.row0:grid.row0 + grid.ny]
    pix_taps = 9.0 * FIELD_P ** 2 * grid.nx * float(real_rows.sum())
    # x/y slots K4 reads: padded row q up to the largest bound of the real
    # rows q-1..q+1 it neighbours, over the real columns and their two
    # wrapped neighbours; it writes nothing per slot.
    v = torch.zeros(grid.ny_pad + 2, dtype=real_rows.dtype, device=dev)
    v[grid.row0 + 1:grid.row0 + 1 + grid.ny] = real_rows
    slots_read = float(torch.maximum(torch.maximum(v[:-2], v[1:-1]),
                                     v[2:]).sum())
    xy_b = 2 * 4.0 * min(grid.nx + 2, grid.nx_pad) * slots_read
    kernels.append(dict(
        name="field_raster", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/field.cu",
        replaces="bevy_gpu_fluid_tpu/render/raster.py:220",
        max_abs_err=float((fk - ft).abs().max()),
        ms=kernel_ms(k4, "field_kernel", 50), wrapper_ms=cuda_ms(k4, 50),
        plain_ms=cuda_ms(t4, 3), library_ms=None,
        **bound(xy_b + occ_b + 4.0 * fk.numel(), pix_taps * DENSITY_OPS)))
    del fk, ft, wet, s
    sess.run_frame(FRAME_SUBSTEPS, FIELD_P)
    zero_counts()
    frame_ms = {}
    shapes = set()
    for pull in (False, True):
        pump = FramePump(pull=pull)
        got = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES_1M):
            img = pump.push(sess.run_frame(FRAME_SUBSTEPS, FIELD_P))
            if img is not None:
                got += 1
                shapes.add(tuple(img.shape))
        last = pump.flush()
        got += 1
        torch.cuda.synchronize()
        frame_ms[pull] = (time.perf_counter() - t0) / FRAMES_1M * 1e3
        check(got == FRAMES_1M, f"pump returned {got} of {FRAMES_1M}")
        lit = (last.astype("int32") if pull else last.int()).sum(-1) > 30
        check(bool(lit.any()), "1M field frame is black")
    launches = counts()
    n_frames = 2 * FRAMES_1M
    print(f"#   1M frame path, Session.run_frame({FRAME_SUBSTEPS}) + field "
          f"frame {sorted(shapes)}: {frame_ms[False]:.3f} ms/frame "
          f"(FramePump on the device), {frame_ms[True]:.3f} ms/frame "
          f"(pulled to the host) on {card}; overflow {sess.overflow}; "
          f"launches {launches}", flush=True)
    check(shapes == {(grid.ny * FIELD_P, grid.nx * FIELD_P, 3)},
          f"frame shapes {shapes}")
    check(launches["field_raster"] == n_frames,
          f"K4 launches {launches['field_raster']} != {n_frames} frames")
    check(launches["density"] == n_frames * FRAME_SUBSTEPS
          and launches["mono_step"] == 0,
          f"1M frame path steps: launches {launches}")
    kernels[-1]["launches"] = launches["field_raster"]
    del sess

    # ---- phase 8: K5 on the --fps grids ----------------------------------
    def fps_scene(n):
        side = math.isqrt(n)
        ext = side * 0.04
        c = bt.IntegrateConfig.create(x_min=-1.0, x_max=ext + 1.0)
        gr = vs.default_grid(0.045, -1.0, ext + 1.0, y_max=ext * 1.1 + 1.0)
        check(gr.n_row_blocks < cuda_solver.MONO_MAX_BLOCKS,
              f"{n}-particle grid has {gr.n_row_blocks} row blocks")
        return bt.init_grid(side, side, 0.04, dev), c, gr, ext * 1.1 + 1.0

    mono_entry = None
    for n in FPS_PLAN:
        st8, cfg8, grid8, _ = fps_scene(n)
        sess8 = vs.Session(st8, params, cfg8, grid8, device=dev)
        sess8.run(MONO_STEPS)
        s = sess8.sim
        margs = (s.xd, s.yd, s.vxd, s.vyd, s.ref_xd, s.ref_yd, params, cfg8,
                 grid8, s.occ)
        k5 = lambda: cuda_solver.mono_step_cuda(*margs)
        t5 = lambda: cuda_solver.mono_step_torch(*margs)
        got, want = k5(), t5()
        pos_err = max(float((g - w).abs().max())
                      for g, w in zip(got[:2], want[:2]))
        vscale = float(torch.maximum(want[2].abs().max(),
                                     want[3].abs().max()))
        vel_err = max(float((g - w).abs().max())
                      for g, w in zip(got[2:4], want[2:4]))
        pos = want[4] > 0
        rho_rel = float(((got[4] - want[4]).abs() / want[4])[pos].max())
        d_err = abs(float(got[5]) - float(want[5]))
        check(pos_err <= 1e-5, f"K5 {n}: position err {pos_err}")
        check(vel_err <= 1e-4 * vscale, f"K5 {n}: velocity err {vel_err}")
        check(rho_rel <= 1e-5 and bool((got[4][~pos] == 0).all()),
              f"K5 {n}: rho rel err {rho_rel}")
        check(d_err <= 1e-4 * float(want[5]), f"K5 {n}: disp2 err {d_err}")

        def two():
            rho = cuda_solver.density_cuda(s.xd, s.yd, params, grid8, s.occ)
            return rho, cuda_solver.forces_integrate_cuda(
                s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, params,
                cfg8, grid8, s.occ)
        rho2, (x2, y2, vx2, vy2, d2) = two()
        lv = s.xd < 5e8
        two_pos = max(float((got[0] - x2).abs().max()),
                      float((got[1] - y2).abs().max()))
        two_vel = max(float((got[2] - vx2).abs().max()),
                      float((got[3] - vy2).abs().max()))
        two_rho = float(((got[4] - rho2).abs() / rho2)[lv].max())
        check(two_pos <= 1e-5 and two_vel <= 1e-4 * vscale
              and two_rho <= 1e-5, f"K5 {n} vs K1+K2: {two_pos} "
              f"{two_vel} {two_rho}")
        mono_dev = kernel_ms(k5, "mono_step_kernel", 100)
        two_dev = device_ms(two, ["density_kernel",
                                  "forces_integrate_kernel"], 100)
        # per step call, host launch cost included, timed in turns
        turns = [cuda_ms(f, 200) for f in (k5, two, two, k5)]
        mono_call, two_call = (turns[0] + turns[3]) / 2, \
            (turns[1] + turns[2]) / 2
        print(f"# phase 8: K5 {n} particles, grid {grid8.plane_shape} "
              f"({grid8.n_row_blocks} row blocks) after {MONO_STEPS} steps: "
              f"vs twin |dx| {pos_err:.3e}, |dv| {vel_err:.3e} of max|v| "
              f"{vscale:.3f}, rho rel {rho_rel:.3e} (all slots); vs K1+K2 "
              f"|dx| {two_pos:.3e} |dv| {two_vel:.3e} rho {two_rho:.3e} "
              f"(live); K5 {mono_dev:.4f} ms vs K1+K2 "
              f"{sum(two_dev.values()):.4f} ms device time (profiler), "
              f"{mono_call:.4f} vs {two_call:.4f} ms per step call (CUDA "
              f"events, in turns: {', '.join(f'{t:.4f}' for t in turns)}) "
              f"on {card}", flush=True)
        if mono_entry is None:     # the largest --fps grid is the table's
            kd, kf = cuda_solver.mono_bounds(s.occ, grid8)
            ops = (live_taps(s.xd, kd, grid8) * DENSITY_OPS
                   + live_taps(s.xd, kf, grid8) * FORCE_OPS
                   + float(lv.sum()) * 20)
            mono_entry = dict(
                name="mono_step", route="cuda",
                source="bevy_gpu_fluid_tpu_torch/csrc/mono_step.cu",
                replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:657",
                max_abs_err=0.0, ms=mono_dev, wrapper_ms=mono_call,
                plain_ms=cuda_ms(t5, 3), library_ms=None,
                two_kernel_ms=sum(two_dev.values()), two_kernel_call_ms=two_call,
                **bound(11 * 4.0 * s.xd.numel() + 4.0 * s.occ.numel() + 4,
                        ops))
        mono_entry["max_abs_err"] = max(
            mono_entry["max_abs_err"], pos_err, vel_err, d_err,
            float((got[4] - want[4]).abs().max()))
        del sess8, s, margs, got, want
    kernels.append(mono_entry)

    # ---- phase 9: the --fps plan through Simulation ------------------------
    fps_lines = []
    for n in FPS_PLAN:
        st9, cfg9, grid9, y_view = fps_scene(n)
        sim9 = bt.Simulation(st9, params, cfg9, grid9, solver="verlet",
                             raster_width=512, y_view_max=y_view, device=dev)
        sim9.run_frame(FRAME_SUBSTEPS, "density")        # warm-up
        sim9.run_frames(2, FRAME_SUBSTEPS, "field")
        zero_counts()
        step0 = sim9._session.sim.step
        field_frames = 0
        fps = {}
        for label, mode, batch, pull in (
                ("splat per-frame, device", "density", 1, False),
                ("splat per-frame, pulled", "density", 1, True),
                ("splat batched x32, device", "density", FPS_BATCH, False),
                ("splat batched x32, pulled", "density", FPS_BATCH, True),
                ("field batched x32, device", "field", FPS_BATCH, False),
                ("field batched x32, pulled", "field", FPS_BATCH, True)):
            calls = FPS_FRAMES if batch == 1 else FPS_BATCHES
            pump = FramePump(pull=pull)
            frames = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                img = (sim9.run_frame(FRAME_SUBSTEPS, mode) if batch == 1
                       else sim9.run_frames(batch, FRAME_SUBSTEPS, mode))
                if pump.push(img) is not None:
                    frames += batch
            last = pump.flush()
            frames += batch
            torch.cuda.synchronize()
            fps[label] = frames / (time.perf_counter() - t0)
            if mode == "field":
                field_frames += frames
            lit = (torch.from_numpy(last) if pull else last).int().sum(-1)
            check(bool((lit > 30).any()), f"{n} {label}: black frame")
        steps = sim9._session.sim.step - step0
        launches = counts()
        line = (f"{n} particles ({grid9.n_row_blocks} row blocks), "
                f"{FRAME_SUBSTEPS} substeps/frame: " + ", ".join(
                    f"{k} {v:.1f} FPS" for k, v in fps.items()))
        fps_lines.append(line)
        print(f"# phase 9: {line}; overflow {sim9.overflow}; launches "
              f"{launches} over {steps} steps on {card}", flush=True)
        check(sim9.overflow == 0, f"{n}: overflow {sim9.overflow}")
        check(launches["mono_step"] == steps and launches["density"] == 0
              and launches["forces_integrate"] == 0,
              f"{n}: K5 {launches['mono_step']} != {steps} steps or K1/K2 ran")
        check(launches["field_raster"] == field_frames,
              f"{n}: K4 {launches['field_raster']} != {field_frames} frames")
        if n == FPS_PLAN[0]:   # the grid of the table's ms and bound
            mono_entry["launches"] = launches["mono_step"]
        del sim9

    st9, cfg9, grid9, y_view = fps_scene(FPS_PLAN[-1])
    a9, b9 = (bt.Simulation(st9, params, cfg9, grid9, y_view_max=y_view,
                            device=dev) for _ in range(2))
    fa = a9.run_frames(4, FRAME_SUBSTEPS, "field")
    fb = torch.stack([b9.run_frame(FRAME_SUBSTEPS, "field")
                      for _ in range(4)])
    same = torch.equal(fa, fb) and all(
        torch.equal(getattr(a9._session.sim, f), getattr(b9._session.sim, f))
        for f in ("xd", "yd", "vxd", "vyd", "rho_d", "idx_d"))
    print(f"#   run_frames(4) vs 4 x run_frame, {FPS_PLAN[-1]} particles: "
          f"state planes and field frames bitwise equal: {same}", flush=True)
    check(same, "run_frames(4) differs from 4 sequential run_frame calls")

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
