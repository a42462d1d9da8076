"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_gpu_fluid_tpu_torch/csrc`` and
drives its main path — the Verlet ``Session`` on the 1M-particle dam break
of ``bench.py`` — then checks it:

1. device and ``nvidia-smi`` name / power limit;
2. kernel build (nvcc, sm_90a), with its time;
3. after 300 steps: each kernel (K1 density, K2 forces+integrate, K3
   reslot) against its PyTorch twin on the Session's own planes; the
   kernel timed alone (torch.profiler device time), its wrapper and its
   twin with CUDA events;
4. the main path: 600 more steps, with every launch counter zeroed first;
   fields finite, no overflow or loss, at least 2 rebins, K1/K2 launched
   once per step and K3 once per rebin; ms/step and particle-steps/s;
5. overflow recovery (9 particles in one cell at cap 8);
6. parity with the port's golden model on the 5,041-particle scene at the
   reference bars.

Every phase raises on failure.  The last lines are the kernel table (JSON),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SIDE = 1000          # bench.py's 1M scene: 1000 x 1000 at spacing 0.04
WARM_STEPS = 300
MAIN_STEPS = 600


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


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds of the CUDA kernel named ``kernel`` per
    call of ``fn`` (a wrapper that launches it once), from torch.profiler's
    device trace: the kernel alone, without the wrapper's host work and
    other launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, "device_time_total", 0) or e.cuda_time_total
          for e in prof.key_averages() if kernel in e.key]
    check(len(us) == 1 and us[0] > 0,
          f"profiler shows no device time for {kernel}")
    return us[0] / 1e3 / reps


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
        plain_ms=cuda_ms(t1, 3)))

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
    kernels.append(dict(
        name="forces_integrate", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:400",
        max_abs_err=max(pos_err, vel_err, d_err),
        ms=kernel_ms(k2, "forces_integrate_kernel", 50),
        wrapper_ms=cuda_ms(k2, 50), plain_ms=cuda_ms(t2, 3)))

    planes = (s.xd, s.yd, s.vxd, s.vyd, s.idx_d)
    k3 = lambda: reslot.reslot_cuda(*planes, grid)
    t3 = lambda: reslot.reslot_torch(*planes, grid)
    got, want = k3(), t3()
    for name, g, w in zip(("x", "y", "vx", "vy", "idx", "cnt"), got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"K3 reslot {name} not bitwise equal to its twin")
    print(f"#   K3 reslot: all six outputs bitwise equal; matched "
          f"{int(got[5].sum())} of {int(live.sum())} live slots")
    kernels.append(dict(
        name="reslot", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/reslot.cu",
        replaces="bevy_gpu_fluid_tpu/ops/reslot.py:203",
        max_abs_err=max(float((g.double() - w.double()).abs().max())
                        for g, w in zip(got, want)),
        ms=kernel_ms(k3, "reslot_kernel", 20), wrapper_ms=cuda_ms(k3, 20),
        plain_ms=cuda_ms(t3, 3)))
    del got, want, rho_k, rho_t

    # ---- phase 4: the main path ------------------------------------------
    wrappers = {"density": cuda_solver.density_cuda,
                "forces_integrate": cuda_solver.forces_integrate_cuda,
                "reslot": reslot.reslot_cuda}
    for w in wrappers.values():
        w.launches = 0
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
    launches = {k: w.launches for k, w in wrappers.items()}
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
              f"events) per call at {grid.plane_shape} on {card}")
    check(finite, "non-finite field after the main path")
    check(sim.overflow == 0 and sim.lost == 0,
          f"overflow {sim.overflow} lost {sim.lost}")
    check(rebins >= 2, f"only {rebins} rebins in the main path")
    check(launches["density"] == MAIN_STEPS
          and launches["forces_integrate"] == MAIN_STEPS,
          f"K1/K2 launches {launches} != {MAIN_STEPS} steps")
    check(launches["reslot"] == rebins,
          f"K3 launches {launches['reslot']} != {rebins} rebins")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    out = sess.state()
    check(bool(torch.isfinite(out.x).all() & (out.x < 5e8).all()),
          "extracted state not finite")
    del sess, s, sim, out, planes, fargs

    # ---- phase 5: overflow recovery --------------------------------------
    rcfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
    rgrid = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    rsess = vs.Session(bt.init_grid(3, 3, 0.004, dev), params, rcfg, rgrid,
                       device=dev)
    over0 = rsess.overflow
    rsess.run(60)
    ids = torch.sort(torch.cat([rsess.sim.idx_d.reshape(-1),
                                rsess.sim.sidx])).values[-rsess.n:]
    print(f"# phase 5: recovery: overflow at init {over0}, readmitted "
          f"{rsess.readmitted}, suspended {rsess.suspended}, rebins "
          f"{rsess.sim.rebin_count - 1}", flush=True)
    check(over0 == 1, f"recovery scene overflow at init {over0}")
    check(rsess.readmitted >= 1, "recovery scene: nothing readmitted")
    check(torch.equal(ids.cpu(), torch.arange(rsess.n, dtype=torch.int32)),
          "recovery scene: ids are not exactly {0..n-1}")

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
    print(f"# phase 6: parity vs golden, 5,041 particles x 10 steps: rho "
          f"{rho_rel:.3e} (<= 3e-3), p {p_abs:.3e} (<= 30), |dx| {dx:.3e} "
          f"(<= 5.18e-4), |dv| {dv:.3e} (<= 0.2456)", flush=True)
    check(psess.overflow == 0, "parity scene overflowed")
    check(rho_rel <= 0.003 and p_abs <= 30.0, "parity: rho/p bars")
    check(dx <= 0.000518 and dv <= 0.245602, "parity: drift bars")

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
