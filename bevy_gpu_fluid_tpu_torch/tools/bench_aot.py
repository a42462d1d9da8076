"""Serving cold start with and without an exported artifact, measured on
the card (port of the repo's ``tools/bench_aot.py``).

Three phases, each a FRESH process launched one after another by the
orchestrator, which records each process's wall clock: that is the worker
cold start a fleet operator sees.

  export  build the 1M Session (skin 1.75), run 100 steps (``--steps``),
          save the resident state and export ``run(100)`` (``utils/aot.
          export_session_run``)
  trace   restore the state (``Session.restore``), first 100-step run done
  load    restore the state (``checkpoint.load_dense``), ``load_exported``,
          first 100-step run done

``load`` runs twice (``aot_first_ever_s``, then ``aot_cold_start_s``).
What "trace" measures here: the reference's worker re-traces and lowers
every jitted program before its first dispatch; eager PyTorch traces
nothing, so the port's "trace" phase is the plain cold start (the torch
import, the kernels' library load, the restore, 100 eager steps) and the
artifact has no tracing to save (``utils/aot.py``).  The two cold starts
run the same 100 steps from the same snapshot, bitwise, so their density
sums must be equal.  Files go to a temporary directory.

    python -m bevy_gpu_fluid_tpu_torch.tools.bench_aot --n 1000000

Left out, TPU-only: the export's ``allow_tpu_custom_calls`` and the
persistent compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from . import dam_break, resolve, sync

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def phase_export(n: int, steps: int, work: str, device) -> dict:
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver
    from bevy_gpu_fluid_tpu_torch.utils import aot

    state, params, cfg, grid, _ = dam_break(n, device, skin=1.75)
    t0 = time.perf_counter()
    sess = verlet_solver.Session(state, params, cfg, grid, device=device)
    sess.run(steps)
    sync(device)
    t_ready = time.perf_counter() - t0
    sess.save(os.path.join(work, "state.npz"))
    art = os.path.join(work, "run.pt2")
    t0 = time.perf_counter()
    aot.export_session_run(sess, steps, art)
    return {"phase": "export", "build_to_ready_s": t_ready,
            "export_s": time.perf_counter() - t0,
            "artifact_bytes": os.path.getsize(art)}


def phase_trace(n: int, steps: int, work: str, device) -> dict:
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver

    t0 = time.perf_counter()
    sess = verlet_solver.Session.restore(os.path.join(work, "state.npz"),
                                         device=device)
    sess.run(steps)
    sync(device)
    return {"phase": "trace",
            "restore_to_first_batch_s": time.perf_counter() - t0,
            "probe": float(sess.sim.rho_d.sum())}


def phase_load(n: int, steps: int, work: str, device) -> dict:
    from bevy_gpu_fluid_tpu_torch.utils import aot, checkpoint

    t0 = time.perf_counter()
    sim = checkpoint.load_dense(os.path.join(work, "state.npz"), device)[0]
    run = aot.load_exported(os.path.join(work, "run.pt2"), out_like=sim)
    sim = run(sim)
    sync(device)
    return {"phase": "load",
            "restore_to_first_batch_s": time.perf_counter() - t0,
            "probe": float(sim.rho_d.sum())}


PHASES = {"export": phase_export, "trace": phase_trace, "load": phase_load}


def fresh_process(phase: str, n: int, steps: int, work: str,
                  cpu: bool) -> dict | None:
    """Run one phase in a fresh Python process; its JSON line's dict with
    the process's wall clock (``process_wall_s``), or None when the
    process failed (its stderr's end is written to ours)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", __spec__.name, "--n", str(n), "--steps",
           str(steps), "--phase", phase, "--work", work] + ["--cpu"] * cpu
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=1800, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        return None
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("{")][-1]
    return dict(json.loads(line), process_wall_s=wall)


def cold_starts(n: int = 1_000_000, steps: int = 100, device="cuda",
                run_phase=fresh_process) -> dict:
    """The orchestrator: each phase through ``run_phase`` (by default a
    fresh process), one after another (no torch work here); returns the
    summary line's dict with ``ok`` (every phase exited 0 and the two cold
    starts agree bitwise)."""
    cpu = resolve(device).type == "cpu"
    results = {}
    with tempfile.TemporaryDirectory() as work:
        for key, phase in (("export", "export"), ("trace", "trace"),
                           ("load_cold", "load"), ("load", "load")):
            res = run_phase(phase, n, steps, work, cpu)
            if res is None:
                print(json.dumps({"metric": "aot_cold_start", "n": n,
                                  "failed_phase": key, "ok": False}))
                return {"failed_phase": key, "ok": False}
            results[key] = res
            print(f"# {key}: {res}", file=sys.stderr)
    same = results["trace"]["probe"] == results["load"]["probe"]
    out = {"metric": "aot_cold_start", "n": n, "steps": steps,
           "trace_cold_start_s": results["trace"]["process_wall_s"],
           "aot_cold_start_s": results["load"]["process_wall_s"],
           "aot_first_ever_s": results["load_cold"]["process_wall_s"],
           "speedup": (results["trace"]["process_wall_s"]
                       / results["load"]["process_wall_s"]),
           "artifact_mb": results["export"]["artifact_bytes"] / 2**20,
           "first_build_s": results["export"]["build_to_ready_s"],
           "export_s": results["export"]["export_s"],
           "probes_equal": same, "device": "cpu" if cpu else "cuda",
           "ok": same}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=100,
                    help="steps of the exported run and of each cold start")
    ap.add_argument("--phase", choices=sorted(PHASES),
                    help="run one phase in this process (the orchestrator "
                         "passes it to its children)")
    ap.add_argument("--work", help="[--phase] the state and artifact "
                                   "directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' PyTorch twins); the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.phase:
        if not args.work:
            ap.error("--phase needs --work")
        print(json.dumps(PHASES[args.phase](args.n, args.steps, args.work,
                                            resolve(device))))
        return 0
    return 0 if cold_starts(args.n, args.steps, device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
