"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``bevy_gpu_fluid_tpu_torch/csrc`` and
drives its paths — the Verlet ``Session`` on the 1M-particle dam break of
``bench.py``, its field-frame loop, the ``bench.py --fps`` plan through
the ``Simulation`` facade, the planar-rebin Session, and the eager solver
with the validator — then checks them:

1. device and ``nvidia-smi`` name / power limit;
2. kernel build (one nvcc per source in parallel, sm_90a), with its time;
3. after 300 steps: each step kernel (K1 density, K2 forces+integrate, K3
   reslot) against its PyTorch twin on the Session's own planes (K1 on
   every slot, K2's dead slots bitwise); the kernel timed alone
   (torch.profiler device time), its wrapper and its twin with CUDA
   events; its bound (bytes or float32 operations of this run's inputs
   over the H100's peak rates); the planes' live share and slot bounds,
   the pair taps K1/K2 need and execute, and their registers, shared
   memory and blocks per SM;
4. the main path: 600 more steps, with every launch counter zeroed first;
   fields finite, no overflow or loss, at least 2 rebins, K1/K2 launched
   once per step, K3 once per rebin, K5 never (85 row blocks); ms/step and
   particle-steps/s; then 60 profiled steps: device time per step by
   kernel and the device's idle share;
5. overflow recovery (9 particles in one cell at cap 8; a 7-row-block grid,
   so it steps on K5);
6. parity with the port's golden model on the 5,041-particle scene at the
   reference bars (also K5);
7. K4 (field raster, P = 2, and P = 5) on the 1M planes against its twin,
   timed, with its registers, shared memory, blocks per SM and the bytes
   its tiles stage beside its bound; then the frame path:
   ``Session.run_frame(16)`` through ``FramePump(pull=False)`` and
   ``FramePump(pull=True)``, counters zeroed first, K4 once per frame;
   ms/frame;
8. K5 (mono step) on the three ``--fps`` grids (10k, 5,041, 1,024
   particles) after 100 steps, against its twin (live slots within the
   tolerances, every output of the dead slots bitwise) and against K1 + K2
   on live slots; K5 timed against K1 + K2 per grid, device time and per
   step call in turns (the mono threshold, measured on the card); K5's
   registers, shared memory and blocks per SM, the bytes its tiles stage,
   and an empty kernel on K5's launch shape (the practical floor);
9. the ``--fps`` plan through ``Simulation``: 16 substeps per frame, splat
   per frame and batched x32, field batched x32, each with the pump on
   the device and pulled to the host; counters zeroed first: K5 once per
   step, K1/K2 never, K4 once per field frame; overflow 0, frames not
   black; ``run_frames(4)`` bitwise equal to 4 ``run_frame`` calls; FPS;
10. K8 (forces alone) on phase 3's 1M planes against its twin (dead slots
    and ghost blocks bitwise +0), its registers, shared memory and blocks
    per SM and the bytes its tiles stage beside its bound, and K1 -> K8 ->
    torch integrate against K2; then the unfused 1M Session
    (``stencils=make_stencils``), counters zeroed first: K1 and K8 once
    per step, K3 once per rebin, K2 never; per particle against a fused
    Session from the same state;
11. K6 (select) and K7 (apply) on 1M planes taken after phase 4 at a step
    where the rebin trigger fires: against their twins bitwise, int32 and
    int8 codes, float32 and int32 payloads; ``reslot_planar`` against K3
    bitwise; timed, with their bounds (K6's with its registers, shared
    memory, blocks per SM and staged bytes), and the planar rebin's
    kernels (K6 + 5 x K7) against K3's;
12. the planar Session at 1M: a fused and a planar Session from the same
    state, 300 + 600 steps in turns, counters zeroed before each run;
    every DenseSim field bitwise equal at the end, K6 once and K7 five
    times per rebin, K3 never on the planar Session; ms/step for both; the
    peak device memory across one rebin (fused vs planar, planar lower);
    the recovery scene of phase 5 planar, bitwise the fused run;
13. the eager solver (K1 + K8, a sort-based binning every step) at 1M on
    bench.py's pallas grid: 100 steps of warm-up, 200 timed, counters
    zeroed first (K1 and K8 once per step, K2/K3/K5 never); ms/step; K8
    against its twin on the planes the next eager step gives it (dead
    slots bitwise +0), timed, with its bound and staged bytes (the kernel
    table's K8 row: launches, time and bound all from this path); then
    ``Simulation(solver="pallas" | "xla")`` on the 5,041-particle scene
    (frames, golden parity at phase 6's bars) and ``validate_every=16``
    on the verlet solver (64 steps) with ``validate(mode="fields")``;
15. the memory ceiling's mechanisms at 1M (phase 4's scene), where they
    can be held against the default posture: K2 refless against its twin
    on the 1M planes (its outputs and displacement max bit for bit K2's
    with the old positions as reference, and its max bit for bit the max
    over its own outputs), timed with its bound (two planes fewer than
    K2's); K1 with ``out=`` bitwise without it; ``init_dense_gen`` of
    ``lattice_gen`` and ``init_dense_chunked`` bitwise ``init_dense``; a
    segmented Session, with and without ``chunk=``, bitwise the standard
    one over 300 steps; a refless Session against the ref-based one
    (|dx| <= 5e-5, rebins >=); ``Session.save`` -> ``restore`` -> 100
    steps bitwise an uninterrupted run in the default and the refless
    posture, a restore under the other trigger refused; and
    ``Simulation.save``/``load`` of the 5,041 scene;
16. the slab decomposition on the one card (``parallel/``, a
    ``SlabMesh`` of D slabs all on cuda:0, phase 4's 1M scene): K2 with a
    slab's lane window, K3 and K6 with its clip [-1, nx_local] and world
    origin, on the 1M planes of a D = 2 slab where the rebin trigger fires
    (ghost columns cleared as the rebin clears them): K3 and K6 bitwise
    their twins (int32 codes), the planar rebin bitwise K3, K2's planes
    bitwise K2 without the window and its max bitwise the max over its own
    outputs in the window, within K2's tolerances of its twin; each timed
    with its bound (the kernel table's ``forces_integrate_lanes``,
    ``reslot_clip`` and ``select_clip`` rows); D = 4 against D = 2
    against the single-card ``Session`` per particle by idx (|dx| <= 1e-6,
    |dv| <= 1e-4, the JAX identity bars) after a window of 25-step chunks
    in which every run has rebinned at least twice;
    ``ShardedSession`` at D = 1, 2 and 4: 300 + 600 steps, counters zeroed
    before the 600 (K1 and K2 D times per step, K2 always with its window,
    K3 D times per rebin and always with the slab's clip, K5 never),
    overflow, dropped and lost 0, every idx once; ms/step, rebins, a
    profiled breakdown and the idle share; the planar ``ShardedSession``
    bitwise the fused one after 300 steps (K6 D and K7 5 D times per
    rebin, K3 never); a frame across both slabs against the single-card
    frame of the same particles (u8 within 1, 99% equal; K4 once per
    slab); ``save`` -> ``restore`` -> 100 steps bitwise;
14. run LAST, after every earlier Session is gone and the cache emptied:
    the postures' peak memory in plane-footprints (peak allocated bytes
    over one plane) on a 16M-particle ``tools/bench_scale.py`` scene, over
    one step and one step that rebins (recovery armed), for the default,
    refless, refless + planar, refless + planar + donate (the ceiling),
    the ceiling segmented and the ceiling on the two-kernel tail (and
    that tail with the plain integrate), with the N each fills this card;
    then the ceiling run: ``Session.from_generator(lattice_gen(...))`` at
    an N the default posture's footprint does not fit and at least 5%
    below the ceiling posture's capacity, every posture left to its
    default (refless and planar must be chosen), its init time and
    ms/step over 100 steps (rebins included), fields finite and in the
    box, overflow and lost 0, K6 once and K7 five times per rebin, K3 and
    K5 never, refless K2 and K1 once per step, its peak memory against the
    card's; a profiled step breakdown, one rebin timed, the recovery
    collect's peak on the ceiling planes; K2 refless timed and bounded on
    the ceiling planes.

17. the sharded very-large-N postures (run after 16, before 14): (a) on
    slab 1 of a refless D = 2 session's 1M planes, K2 refless with the
    slab's lane window (planes bitwise K2 refless over every lane, its max
    bitwise the max of its own moves in the window, within K2's
    tolerances of its twin), K1 with ``out=`` (bitwise K1) and K8 against
    their twins, each timed with its bound (the kernel table's
    ``forces_integrate_refless_lanes``, ``density_out_slab`` and
    ``forces_slab`` rows); (b) at 1M, D = 2: refless against ref-based
    (rebins >=, overflow and lost 0, every idx once, |dx| <= 5e-5, |dv|
    <= 5e-3), segmented + donate + planar + refless bitwise the standard
    refless run across a ``chunk=`` bound, the in-place halo bitwise the
    copying one, ``init_chunks`` and ``from_generator`` bitwise the
    sort-based init, the unfused K1 + K8 step against the fused one at
    phase 10's bars (K8 twice per step), ms/step and device busy time of
    the copying and the in-place halo, a refless save -> restore bitwise;
    (c) the copying (``donate=False``) and owned postures' peaks per slab
    at D = 2 on a 16M scene (pure steps to the trigger, one rebin), each
    within what its automatic choice budgets (``FOOTPRINTS`` plus, copying,
    ``HALO_COPY_FOOTPRINTS``); then the sharded memory ceiling:
    ``ShardedSession.from_generator`` at
    D = 2 on the one card at an N between the per-slab capacities of the
    ref-based planar posture and 0.95 x the ceiling posture (each slab
    budgeted half of the card), every posture left to its default (refless,
    planar and owned planes must be chosen): init seconds, ms/step over at
    least 50 steps with at least one rebin, peak memory in
    slab-plane-footprints per slab (peak bytes over D slab planes),
    overflow, lost and dropped 0, K2 refless with the window and K1 into
    the dead rho twice per step, K6 and 5 x K7 per slab and rebin; then
    the step's peak and the rebin's apart.  ``python3 chip_smoke.py 17``
    runs phase 17 alone and prints no result line.

18. the serving and tooling entry points (run after 17, before 14): the
    interactive server (``examples/interactive.py``) at full width, an
    ``InteractiveApp`` on a 1M ``Session`` (16 substeps per frame, the
    field raster at P = 2) with its frame loop thread and ``make_server``
    on an ephemeral port, driven over HTTP: ``GET /``, then the loop
    alone for 0.15 s and 5 back-to-back ``GET /frame.png`` in 10 turns
    (each kind's frames/s from the loop's own counts over the same stretch
    of the dam break), 20 x ``POST /impulse`` one frame apart along the
    self-drive path, ``POST /toggle``, ``GET /stats``; every PNG decoded
    here with zlib to the latest frame's shape (CRCs checked, not black);
    counters zeroed before the loop starts: K1 and K2 once per step, K3
    once per rebin, K4 once per frame; no particle lost (every one
    resident or parked in the spill; overflow, the recoverable drops,
    recorded: this scene overflows on its own after ~1,300-2,300 steps),
    the fields finite and in the box, a kicked frame's max |vx| grown;
    frames/s, request latency p50/p99, PNG encode ms in the server and
    alone, impulse to frame latency; then ``examples/demo.py`` (5,041
    particles, 60 frames, the native sink; K5 16 times per frame),
    ``examples/sharded_demo.py`` (D = 2 on the card, 12 frames, the
    restore bitwise, identity exact), ``entry()`` (one K5 step) and
    ``dryrun_multichip(4)`` (4 slabs on cuda:0); on a fresh 1M Session
    after 300 steps (phase 4's regime): its artifact (``utils/aot.py``)
    loaded in a fresh process from a checkpoint, its time to the first
    finished step and 100 steps bitwise the live Session; the custom
    operators' host time per step against the direct launchers;
    ``StepTimer`` over 600 steps against CUDA events; a ``trace()`` of 8
    steps naming K1 and K2.  ``python3 chip_smoke.py 18`` runs phase 18
    alone and prints no result line.

Every phase raises on failure.  The last lines are the kernel table (JSON),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

# the memory-ceiling run allocates planes of several GB next to each
# other's transients: segments that grow keep the cache from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_SIDE = 1000          # bench.py's 1M scene: 1000 x 1000 at spacing 0.04
WARM_STEPS = 300
MAIN_STEPS = 600
FIELD_P = 2            # field raster subpixels per cell side
FIELD_P_WIDE = 5       # one more K4 call past the old kernel's P = 1..4
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
UNFUSED_STEPS = 100   # the unfused 1M Session against the fused one
EAGER_WARM = 100   # eager 1M solver: warm-up steps, then timed steps
EAGER_STEPS = 200
VALIDATE_EVERY = 16
BREAKDOWN_STEPS = 60   # profiled 1M steps after the main path (~10 rebins)
SEGMENTED_STEPS = 300  # phase 15: segmented vs standard 1M Sessions
REFLESS_STEPS = 120    # phase 15: refless vs ref-based (the JAX test's 120)
RESTORE_STEPS = 100    # phase 15: steps after a restore
SLAB_COUNTS = (1, 2, 4)   # phase 16: slabs of the timed runs
SLAB_IDENTITY_CHUNK = 25  # phase 16: D = 4 vs D = 2 vs one Session, run
SLAB_IDENTITY_REBINS = 2  # in chunks until each has rebinned this often
SLAB_IDENTITY_MAX = 300   # steps at most
SHARDED_STEPS = 160    # phase 17: the 1M D = 2 posture comparisons
HALO_STEPS = 300       # phase 17: timed steps, copying vs in-place halo
SHARDED_CEILING_MIN = 50    # phase 17: measured ceiling steps, at least,
SHARDED_CEILING_MAX = 150   # and at most (until one rebin is in)
SHARDED_PROBE = {      # phase 17: ShardedSession knobs of each probed
    # posture, and the FOOTPRINTS key its automatic choice budgets it by
    # (plus HALO_COPY_FOOTPRINTS when copying; None: printed only)
    "copying default": (dict(refless_trigger=False, planar_rebin=False,
                             donate=False), "default"),
    "copying planar": (dict(refless_trigger=False, planar_rebin=True,
                            donate=False), "planar"),
    "copying refless_planar": (dict(refless_trigger=True, planar_rebin=True,
                                    donate=False), None),
    "owned ceiling": (dict(refless_trigger=True, planar_rebin=True,
                           donate=True), "ceiling"),
}
SERVER_N = 1_000_000   # phase 18: the interactive server's Session
SERVER_GETS = 50       # GET /frame.png requests,
SERVER_GETS_A_TURN = 5  # back to back, in turns with
SERVER_ALONE_S = 0.15   # the loop alone
SERVER_IMPULSES = 20   # POST /impulse requests, one frame apart
DEMO_N = 5_041         # examples/demo.py's default scene
DEMO_FRAMES = 60
SHARDED_DEMO_FRAMES = 12
DRYRUN_SLABS = 4
AOT_STEPS = 100        # the artifact's run, checked bitwise
DISPATCH_STEPS = 200   # pure steps per turn: direct launchers vs operators
TIMER_STEPS = 600      # StepTimer against CUDA events
TRACE_STEPS = 8
PROBE_N = 16_000_000   # phase 14: the footprint probe's scene
CEILING_STEPS = 100    # phase 14: measured steps of the ceiling run
CEILING_PROFILED = 8   # phase 14: profiled ceiling steps
PROBE_POSTURES = {     # phase 14: Session knobs of each probed posture
    "default": dict(refless_trigger=False, planar_rebin=False,
                    donate=False, segmented=False),
    "planar": dict(refless_trigger=False, planar_rebin=True, donate=False,
                   segmented=False),
    "refless": dict(refless_trigger=True, planar_rebin=False, donate=False,
                    segmented=False),
    "refless_planar": dict(refless_trigger=True, planar_rebin=True,
                           donate=False, segmented=False),
    "ceiling": dict(refless_trigger=True, planar_rebin=True, donate=True,
                    segmented=False),
    "ceiling_segmented": dict(refless_trigger=True, planar_rebin=True,
                              donate=True, segmented=True),
    "ceiling_tail": dict(refless_trigger=True, planar_rebin=True,
                         donate=True, segmented=False, stencils=True),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class SmiSampler:
    """nvidia-smi's SM clock (MHz), power draw (W) and temperature (C)
    every 200 ms while the ``with`` block runs; the sampler process is
    stopped on the way out, whatever happens inside."""

    def __enter__(self) -> "SmiSampler":
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        try:
            out = self.proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out = self.proc.communicate()[0]
        self.rows = [[float(v) for v in line.split(",")]
                     for line in out.splitlines()
                     if line.count(",") == 2
                     and "N/A" not in line and "[" not in line]

    def summary(self) -> str:
        if not self.rows:
            return "no nvidia-smi samples"
        cols = list(zip(*self.rows))
        med = lambda c: sorted(c)[len(c) // 2]
        return (f"{len(self.rows)} nvidia-smi samples: SM clock "
                f"{min(cols[0]):.0f}-{max(cols[0]):.0f} MHz (median "
                f"{med(cols[0]):.0f}), power {min(cols[1]):.0f}-"
                f"{max(cols[1]):.0f} W (median {med(cols[1]):.0f}), "
                f"{max(cols[2]):.0f} C at most")


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


def device_ms(fn, kernels, reps: int, tries: int = 3) -> dict:
    """Mean device milliseconds of each CUDA kernel named in ``kernels``
    (each launched once per call of ``fn``), from torch.profiler's device
    trace: the kernels alone, without the wrapper's host work and other
    launches.  The mean is over the launches the trace recorded: the
    profiler drops a record now and then, and dividing by ``reps`` would
    then read low (a ceiling K2 read 14.9 and 29.9 ms for 44.8 ms
    launches).  A trace with no record of a kernel is taken again, up to
    ``tries`` traces."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {k: [((getattr(e, "device_time_total", 0)
                    or e.cuda_time_total), e.count)
                   for e in prof.key_averages() if k in e.key]
              for k in kernels}
        if all(len(u) == 1 and u[0][0] > 0 and u[0][1] >= 1
               for u in us.values()):
            return {k: u[0][0] / 1e3 / u[0][1] for k, u in us.items()}
    check(False, f"profiler shows no device time for one of {kernels} in "
          f"{tries} traces: {us}")


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


def neighbour_live(xd, occ, grid):
    """Per cell [ny_pad, nx_pad]: its live slots, and the sum and the
    largest of its 3x3 cells' live slots below its row block's bound."""
    live = (xd < 5e8).sum(dim=1)
    km = row_bounds(occ.amax(dim=0), grid)[:, None]
    nsum = torch.zeros_like(live)
    nmax = torch.zeros_like(live)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = torch.minimum(torch.roll(live, (-dy, -dx), (0, 1)), km)
            nsum += nb
            nmax = torch.maximum(nmax, nb)
    return live, nsum, nmax


def tile_taps(xd, occ, grid) -> tuple[float, float]:
    """Pair taps of K1/K2 on these planes: (needed, executed).  Needed:
    each live slot x the live slots of its 3x3 cells below its row block's
    bound (a FAR candidate adds exactly 0).  Executed: each live slot x 9 x
    the largest of those 9 counts, the tiled kernels' per-slot loop."""
    live, nsum, nmax = neighbour_live(xd, occ, grid)
    return float((live * nsum).sum()), 9.0 * float((live * nmax).sum())


def field_taps(xd, occ, grid, P) -> tuple[float, float, float]:
    """Pixel taps of K4 at P subpixels per cell side: (needed, executed by
    its tile kernel, executed by its cell kernel).  Needed: each real cell's
    P^2 pixels x the live slots of its 3x3 cells below its row block's
    bound.  Tile kernel: P^2 x 9 x the largest of those 9 counts.  Cell
    kernel: P^2 x 9 x the row block's bound."""
    _, nsum, nmax = neighbour_live(xd, occ, grid)
    real = (slice(grid.row0, grid.row0 + grid.ny), slice(1, 1 + grid.nx))
    km = row_bounds(occ.amax(dim=0), grid)[real[0]]
    return (P * P * float(nsum[real].sum()),
            9.0 * P * P * float(nmax[real].sum()),
            9.0 * P * P * grid.nx * float(km.sum()))


def read_slots(per_row, first, last) -> float:
    """Slots per column a stencil must read: padded row q up to the
    largest bound ``per_row`` (int [ny_pad], 0 off its targets) of the
    target rows q-1..q+1 it neighbours, over target rows [first, last)."""
    v = torch.zeros(per_row.numel() + 2, dtype=per_row.dtype,
                    device=per_row.device)
    v[first + 1:last + 1] = per_row[first:last]
    return float(torch.maximum(torch.maximum(v[:-2], v[1:-1]), v[2:]).sum())


def bound_k8(xd, occ, grid) -> dict:
    """K8's bound on these planes: five planes read and two written, plus
    occ; K2's force taps of the live slots and ~3 operations of EOS per
    live slot."""
    taps = live_taps(xd, occ.amax(dim=0), grid)
    return bound(7 * 4.0 * xd.numel() + 4.0 * occ.numel(),
                 taps * FORCE_OPS + float((xd < 5e8).sum()) * 3)


def csrc_ints(source: str, *patterns: str) -> tuple[int, ...]:
    """Integer constants of a kernel source under
    bevy_gpu_fluid_tpu_torch/csrc: the integer each pattern captures (a
    tiled kernel's tile rows and columns, say)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bevy_gpu_fluid_tpu_torch", "csrc", source)) as f:
        text = f.read()
    return tuple(int(re.search(p, text).group(1)) for p in patterns)


def staged_bytes(per_block, grid, shape, ring, planes,
                 real_only=False) -> float:
    """Bytes a tiled kernel reads into shared memory: each interior tile's
    cells and its ring of ``ring`` cells, below its row block's slot bound
    (``per_block`` [nb]), from ``planes`` float32 planes (the window slots
    past the grid's edge, staged as FAR without a read, excluded);
    ``real_only``: only the tiles that hold a real cell, as K4 stages."""
    rows, cols = shape
    tb = grid.row_block
    rlo, rhi = (grid.row0, grid.row0 + grid.ny) if real_only else (0, 1 << 30)
    clo, chi = (1, grid.nx + 1) if real_only else (0, 1 << 30)
    col_cells = sum(min(cols, grid.nx_pad - c) + 2 * ring
                    for c in range(0, grid.nx_pad, cols)
                    if c < chi and c + cols > clo)
    cells = 0.0
    for rb, k in enumerate(per_block.tolist()):
        for r in range(0, tb, rows):
            top = (rb + 1) * tb + r
            n = min(rows, tb - r)
            if top < rhi and top + n > rlo:
                cells += (n + 2 * ring) * k
    return 4.0 * planes * col_cells * cells


def bits_equal(a, b) -> bool:
    """Two float32 tensors equal bit for bit (-0 is not +0)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def k8_check(got, want, xd, label):
    """K8 against its twin: max |da| within 1e-5 of max |a|, dead slots
    (ghost blocks included) +0 bit for bit.  Returns (err, max |a|)."""
    a_scale = float(torch.maximum(want[0].abs().max(), want[1].abs().max()))
    a_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    dead = xd >= 5e8
    dead0 = all(bits_equal(a[dead], torch.zeros_like(a[dead]))
                and bits_equal(a[dead], w[dead]) for a, w in zip(got, want))
    check(a_err <= 1e-5 * a_scale and dead0,
          f"K8 forces on {label}: err {a_err}, dead slots +0: {dead0}")
    return a_err, a_scale


def sims_equal(a, b) -> bool:
    """Every field of two DenseSims equal: tensors bitwise, counters."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in ((getattr(a, f.name), getattr(b, f.name))
                            for f in dataclasses.fields(a)))


def slab_sims_equal(a, b) -> bool:
    """Every field of two ShardedDenseSims equal: tensors bitwise (dtype
    included), counters."""
    return all(
        all(u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(x, y))
        if isinstance(x, list) and x and isinstance(x[0], torch.Tensor)
        else x == y
        for x, y in ((getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(a)))


def gc_collect() -> None:
    """Drop unreachable sessions and return the cached blocks to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def paths_1m() -> tuple[list, str]:
    """Phases 1-13; returns the kernel table's rows and the card's line."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.kernels import _build
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
    from bevy_gpu_fluid_tpu_torch.models import reference as golden
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.ops import reslot
    from bevy_gpu_fluid_tpu_torch.ops.binning import (FAR, bin_particles,
                                                      to_dense)
    from bevy_gpu_fluid_tpu_torch.render import raster
    from bevy_gpu_fluid_tpu_torch.render.pump import FramePump
    from bevy_gpu_fluid_tpu_torch.utils import validator

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
    s = warm = sess.sim       # phase 10 reads these planes again
    live = s.xd < 5e8
    plane_b = 4.0 * s.xd.numel()
    occ_b = 4.0 * s.occ.numel()
    kmax_blocks = s.occ.amax(dim=0)
    need_taps, run_taps = tile_taps(s.xd, s.occ, grid)
    slot_taps = 9.0 * grid.nx_pad * grid.cap * float(
        row_bounds(kmax_blocks, grid).sum())
    print(f"#   planes after {WARM_STEPS} steps: live share "
          f"{float(live.float().mean()):.4f} of {s.xd.numel()} slots; slot "
          f"bound per row block max {int(kmax_blocks.max())}, mean "
          f"{float(kmax_blocks.float().mean()):.3f}; pair taps: "
          f"{need_taps / 1e6:.2f}M needed (live x live), "
          f"{run_taps / 1e6:.2f}M executed by K1/K2 (9 x the largest "
          f"neighbour count per live slot), {slot_taps / 1e6:.2f}M for a "
          f"thread per slot over the plane (9 x kmax)")
    occupancy = {}
    for name in ("density", "forces_integrate"):
        occupancy[name] = _build.occupancy(name, grid.cap)
        print(f"#   {name} at cap {grid.cap}: {occupancy[name]} (registers "
              f"per thread, shared memory bytes per block, blocks per SM)")
        check(occupancy[name]["local_bytes"] == 0, f"{name} spills")
    kernels = []

    k1 = lambda: cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
    t1 = lambda: cuda_solver.density_torch(s.xd, s.yd, params, grid, s.occ)
    rho_k, rho_t = k1(), t1()
    rel_all = (rho_k - rho_t).abs() / rho_t.abs().clamp_min(1e-30)
    rel, rel_dead = float(rel_all.max()), float(rel_all[~live].max())
    print(f"#   K1 density: max rel err on every slot {rel:.3e} (<= 1e-5; "
          f"dead slots {rel_dead:.3e})")
    check(rel <= 1e-5, f"K1 density rel err {rel}")
    kernels.append(dict(
        name="density", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/density.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:224",
        max_abs_err=float((rho_k - rho_t).abs().max()),
        ms=kernel_ms(k1, "density_kernel", 50), wrapper_ms=cuda_ms(k1, 50),
        plain_ms=cuda_ms(t1, 3), library_ms=None,
        **occupancy["density"],
        **bound(3 * plane_b + occ_b, need_taps * DENSITY_OPS)))

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
    dead = ~live
    dead_same = (torch.equal(got[0][dead], s.xd[dead])
                 and torch.equal(got[1][dead], s.yd[dead])
                 and bool((got[2][dead] == 0).all()
                          & (got[3][dead] == 0).all()))
    print(f"#   K2 forces+integrate: |dx| {pos_err:.3e} (<= 1e-5), |dv| "
          f"{vel_err:.3e} of max|v| {vscale:.3f} (<= 1e-4 rel), disp2 "
          f"{float(got[4]):.6e} vs {float(want[4]):.6e}; dead slots x, y "
          f"unchanged and v 0 (bitwise): {dead_same}")
    check(pos_err <= 1e-5, f"K2 position err {pos_err}")
    check(vel_err <= 1e-4 * vscale, f"K2 velocity err {vel_err}")
    check(d_err <= 1e-4 * float(want[4]), f"K2 disp2 err {d_err}")
    check(dead_same, "K2 dead slots not x, y unchanged and v 0")
    n_live = float(live.sum())
    kernels.append(dict(
        name="forces_integrate", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:400",
        max_abs_err=max(pos_err, vel_err, d_err),
        ms=kernel_ms(k2, "forces_integrate_kernel", 50),
        wrapper_ms=cuda_ms(k2, 50), plain_ms=cuda_ms(t2, 3), library_ms=None,
        **occupancy["forces_integrate"],
        **bound(11 * plane_b + occ_b + 4,
                need_taps * FORCE_OPS + n_live * 20)))   # EOS + integrate

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
                "mono_step": cuda_solver.mono_step_cuda,
                "forces": cuda_solver.forces_cuda,
                "select": reslot.select_cuda,
                "apply_code": reslot.apply_code_cuda}

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
    # where a 1M step's time goes: device time by kernel over BREAKDOWN_STEPS
    # more steps (torch.profiler), and the device's idle share of the
    # unprofiled ms/step above
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.run(BREAKDOWN_STEPS)
        torch.cuda.synchronize()
    by_kernel = sorted(
        ((e.device_time_total / 1e3 / BREAKDOWN_STEPS, e.count,
          e.key.replace("(anonymous namespace)::", "").replace("void ", "")
          .split("(")[0].split("<")[0][-40:])
         for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA
         and e.device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in by_kernel)
    print(f"#   1M step breakdown over {BREAKDOWN_STEPS} steps "
          f"(torch.profiler device time): busy {busy:.4f} ms/step of "
          f"{ms_step:.4f}, idle share {1 - busy / ms_step:.3f}; by kernel "
          f"per step: " + "; ".join(
              f"{name} {ms:.4f} ms x{c}" for ms, c, name in by_kernel[:8]),
          flush=True)
    out = sess.state()
    check(bool(torch.isfinite(out.x).all() & (out.x < 5e8).all()),
          "extracted state not finite")
    # step on to where the rebin trigger fires: phase 11's planes
    to_need = 0
    while not sess._need(sess.sim):
        sess.sim = sess._pure_step(sess.sim)
        to_need += 1
    need_sim = sess.sim
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

    fused_recovery = rsess.sim

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
    occ_now = reslot.block_kmax3(s.xd, grid)
    # x/y slots K4 must read: padded row q up to the largest bound of the
    # real rows q-1..q+1 it neighbours, over the real columns and their two
    # wrapped neighbours; it writes the field and nothing per slot.  Its
    # operations: each pixel's taps on live slots (a FAR tap adds 0).
    xy_b = 2 * 4.0 * min(grid.nx + 2, grid.nx_pad) * read_slots(
        row_bounds(occ_now.amax(dim=0), grid), grid.row0,
        grid.row0 + grid.ny)
    # K4 runs a thread per cell for P <= kCellP, its halo tile above
    field_occ = _build.occupancy("field", grid.cap)       # the tile kernel's
    check(field_occ["local_bytes"] == 0, "field spills")
    *field_tile, cell_p = csrc_ints("field.cu", r"kFieldRows = (\d+);",
                                    r"kFieldCols = (\d+);",
                                    r"kCellP = (\d+);")
    staged = staged_bytes(occ_now.amax(dim=0), grid, field_tile, 1, 2,
                          real_only=True)
    k4_rows = {}
    for P in (FIELD_P, FIELD_P_WIDE):
        tiled = P > cell_p
        k4 = lambda: raster.field_density_cuda(s.xd, s.yd, params, grid, P)
        t4 = lambda: raster.field_density(s.xd, s.yd, params, grid, P)
        fk, ft = k4(), t4()
        wet = ft > 0.05 * float(params.rho_0)
        f_rel = float(((fk - ft).abs() / ft)[wet].max())
        check(f_rel <= 1e-5, f"K4 field rel err {f_rel} at P = {P}")
        check(tuple(fk.shape) == (grid.ny * P, grid.nx * P),
              f"field shape {tuple(fk.shape)} at P = {P}")
        need_px, tile_px, cell_px = field_taps(s.xd, occ_now, grid, P)
        run_px = tile_px if tiled else cell_px
        r = k4_rows[P] = dict(
            max_abs_err=float((fk - ft).abs().max()),
            ms=kernel_ms(k4, "field_tile_kernel" if tiled
                         else "field_cell_kernel", 50),
            wrapper_ms=cuda_ms(k4, 50), plain_ms=cuda_ms(t4, 3),
            **bound(xy_b + occ_b + 4.0 * fk.numel(), need_px * DENSITY_OPS))
        print(f"# phase 7: K4 field raster P={P} at {tuple(fk.shape)}: max "
              f"rel err on {int(wet.sum())} wet pixels {f_rel:.3e} (<= "
              f"1e-5), max abs {r['max_abs_err']:.3e}; kernel {r['ms']:.4f} "
              f"ms (profiler), wrapper {r['wrapper_ms']:.4f}, twin "
              f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bound_bytes'] / 1e6:.1f} MB: x/y below "
              f"the row bounds and the field; {need_px / 1e6:.1f}M pixel "
              f"taps needed, {run_px / 1e6:.1f}M executed by the "
              f"{'tile' if tiled else 'cell'} kernel, the tile kernel's "
              f"{tile_px / 1e6:.1f}M; " + (
                  f"its tiles stage {staged / 1e6:.1f} MB, x, y below kmax, "
                  f"tile {tuple(field_tile)} + a one-cell ring" if tiled else
                  "x, y read through L1") + f") on {card}", flush=True)
        del fk, ft, wet
    print(f"#   K4's tile kernel (P > {cell_p}) at cap {grid.cap}: "
          f"{field_occ} (registers per thread, shared memory bytes per "
          f"block, blocks per SM)", flush=True)
    wide = {k: v for k, v in k4_rows[FIELD_P_WIDE].items()
            if k in ("ms", "max_abs_err", "bound_ms", "bound_by")}
    wide.update(staged_bytes=staged, **field_occ)
    kernels.append(dict(
        name="field_raster", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/field.cu",
        replaces="bevy_gpu_fluid_tpu/render/raster.py:220",
        library_ms=None, **k4_rows[FIELD_P],
        **{f"p{FIELD_P_WIDE}_{k}": v for k, v in wide.items()}))
    del s
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
        lv = s.xd < 5e8
        dead_same = all(bits_equal(g[~lv], w[~lv])
                        for g, w in zip(got[:5], want[:5]))
        check(dead_same, f"K5 {n}: dead slots not bitwise the twin's")

        def two():
            rho = cuda_solver.density_cuda(s.xd, s.yd, params, grid8, s.occ)
            return rho, cuda_solver.forces_integrate_cuda(
                s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, params,
                cfg8, grid8, s.occ)
        rho2, (x2, y2, vx2, vy2, d2) = two()
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
              f"{vscale:.3f}, rho rel {rho_rel:.3e} (all slots), dead "
              f"slots bitwise {dead_same}; vs K1+K2 "
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
            mono_occ = _build.occupancy("mono_step", grid8.cap)
            check(mono_occ["local_bytes"] == 0, "mono_step spills")
            # the practical floor: an empty kernel on K5's launch shape
            floor_ms = kernel_ms(lambda: _build.launch(
                "bgf_mono_floor", dev, grid8.ny_pad, grid8.nx_pad,
                grid8.row_block), "mono_floor_kernel", 100)
            mono_tile = csrc_ints("mono_step.cu", r"kMonoRows = (\d+);",
                                   r"HaloTile<kMonoRows, (\d+), 2>")
            mono_entry = dict(
                name="mono_step", route="cuda",
                source="bevy_gpu_fluid_tpu_torch/csrc/mono_step.cu",
                replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:657",
                max_abs_err=0.0, ms=mono_dev, wrapper_ms=mono_call,
                plain_ms=cuda_ms(t5, 3), library_ms=None,
                two_kernel_ms=sum(two_dev.values()), two_kernel_call_ms=two_call,
                empty_kernel_ms=floor_ms, **mono_occ,
                **bound(11 * 4.0 * s.xd.numel() + 4.0 * s.occ.numel() + 4,
                        ops))
            staged = staged_bytes(kd, grid8, mono_tile, 2, 4)
            print(f"#   K5 at {grid8.plane_shape}: tile {mono_tile} + a "
                  f"two-cell ring, {mono_occ} (registers per thread, shared "
                  f"memory bytes per block, blocks per SM); stages "
                  f"{staged / 1e6:.3f} MB (x, y, vx, vy below kmax_d) and "
                  f"writes {5 * 4.0 * s.xd.numel() / 1e6:.3f} MB; bound "
                  f"{mono_entry['bound_ms']:.4f} ms by "
                  f"{mono_entry['bound_by']}; an empty kernel on its launch "
                  f"shape {floor_ms:.4f} ms (profiler), the practical floor; "
                  f"K5 {mono_dev:.4f} ms on {card}", flush=True)
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

    # ---- phase 10: K8 on phase 3's 1M planes; the unfused Session ---------
    s = warm
    rho = cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
    f8 = (s.xd, s.yd, s.vxd, s.vyd, rho, params, grid, s.occ)
    k8 = lambda: cuda_solver.forces_cuda(*f8)
    t8 = lambda: cuda_solver.forces_torch(*f8)
    got, want = k8(), t8()
    a_err, a_scale = k8_check(got, want, s.xd, "the Session's planes")
    unfused = cuda_solver.integrate(s.xd, s.yd, s.vxd, s.vyd, *got, s.ref_xd,
                                    s.ref_yd, cfg)
    fused = cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, params, cfg, grid,
        s.occ)
    u_pos = max(float((a - b).abs().max())
                for a, b in zip(unfused[:2], fused[:2]))
    vscale = float(torch.maximum(fused[2].abs().max(), fused[3].abs().max()))
    u_vel = max(float((a - b).abs().max())
                for a, b in zip(unfused[2:4], fused[2:4]))
    u_d = abs(float(unfused[4]) - float(fused[4]))
    print(f"# phase 10: K8 forces on the 1M planes: max |da| {a_err:.3e} of "
          f"max |a| {a_scale:.1f} (<= 1e-5 rel), dead slots and ghost blocks "
          f"+0 bitwise; "
          f"K1 -> K8 -> torch integrate vs K2: |dx| {u_pos:.3e} (<= 1e-5), "
          f"|dv| {u_vel:.3e} of max|v| {vscale:.3f} (<= 1e-4 rel), disp2 "
          f"{float(unfused[4]):.6e} vs {float(fused[4]):.6e}", flush=True)
    check(u_pos <= 1e-5 and u_vel <= 1e-4 * vscale
          and u_d <= 1e-4 * float(fused[4]),
          f"K1+K8+integrate vs K2: {u_pos} {u_vel} {u_d}")
    k8_session = bound_k8(s.xd, s.occ, grid)
    forces_occ = _build.occupancy("forces", grid.cap)
    check(forces_occ["local_bytes"] == 0, "forces spills")
    k8_tile = csrc_ints("bgf_common.cuh", r"kTileRows = (\d+);",
                         r"kTileCols = (\d+);")
    print(f"#   forces on the Session's planes: kernel "
          f"{kernel_ms(k8, 'forces_kernel', 50):.4f} ms (profiler), bound "
          f"{k8_session['bound_ms']:.4f} ms by {k8_session['bound_by']} "
          f"({k8_session['bound_bytes'] / 1e6:.1f} MB: 7 whole planes); the "
          f"tiles stage {staged_bytes(s.occ.amax(dim=0), grid, k8_tile, 1, 5) / 1e6:.1f}"
          f" MB (5 planes below kmax, tile {k8_tile} + a one-cell ring) and "
          f"write 2 planes; {forces_occ} (registers per thread, shared "
          f"memory bytes per block, blocks per SM) at {grid.plane_shape} on "
          f"{card} (the table's K8 row is phase 13's)", flush=True)
    del warm, s, rho, f8, got, want, unfused, fused
    # the unfused Session posture (K1 + K8 + torch integrate) against the
    # fused one, from the same 1M state
    us = vs.Session(state, params, cfg, grid, device=dev,
                    stencils=cuda_solver.make_stencils(grid))
    fs10 = vs.Session(state, params, cfg, grid, device=dev)
    zero_counts()
    r0 = us.sim.rebin_count
    torch.cuda.synchronize()
    start.record()
    us.run(UNFUSED_STEPS)
    end.record()
    end.synchronize()
    u_ms = start.elapsed_time(end) / UNFUSED_STEPS
    launches = counts()
    u_rebins = us.sim.rebin_count - r0
    fs10.run(UNFUSED_STEPS)
    ua, fa = us.state(), fs10.state()
    u_dx = max(float((ua.x - fa.x).abs().max()),
               float((ua.y - fa.y).abs().max()))
    vscale = float(torch.maximum(fa.vx.abs().max(), fa.vy.abs().max()))
    u_dv = max(float((ua.vx - fa.vx).abs().max()),
               float((ua.vy - fa.vy).abs().max()))
    print(f"#   unfused 1M Session (stencils=make_stencils), "
          f"{UNFUSED_STEPS} steps: {u_ms:.4f} ms/step (CUDA events) on "
          f"{card}; rebins {u_rebins} / {fs10.sim.rebin_count - r0} fused; "
          f"vs the fused Session |dx| {u_dx:.3e} (<= 1e-4), |dv| "
          f"{u_dv:.3e} of max|v| {vscale:.3f} (<= 1e-3 rel); overflow "
          f"{us.overflow}; launches {launches}", flush=True)
    check(launches["density"] == UNFUSED_STEPS
          and launches["forces"] == UNFUSED_STEPS
          and launches["forces_integrate"] == launches["mono_step"] == 0
          and launches["reslot"] == u_rebins,
          f"unfused Session launches {launches} for {UNFUSED_STEPS} steps, "
          f"{u_rebins} rebins")
    check(us.overflow == 0 and u_dx <= 1e-4 and u_dv <= 1e-3 * vscale,
          f"unfused Session vs fused: {u_dx} {u_dv} overflow {us.overflow}")
    del us, fs10, ua, fa

    # ---- phase 11: K6 and K7 on 1M planes where the trigger fires ---------
    s = need_sim
    occ = s.occ
    planes = (s.xd, s.yd, s.vxd, s.vyd, s.idx_d)
    fills = (1e9, 1e9, 0.0, 0.0, -1)
    rows_k6 = row_bounds(occ.amax(dim=0), grid)
    cand = 9.0 * grid.nx_pad * float(rows_k6.sum())
    cnt_b = 4.0 * grid.ny_pad * grid.nx_pad
    # x/y slots K6 must read: padded row q up to the largest bound of the
    # interior rows q-1..q+1 it neighbours, over every column (K4's rule)
    k6_xy_b = 2 * 4.0 * grid.nx_pad * read_slots(
        rows_k6, grid.row_block, grid.ny_pad - grid.row_block)
    select_occ = _build.occupancy("select", grid.cap)
    check(select_occ["local_bytes"] == 0, "select spills")
    select_tile = csrc_ints("select.cu", r"kSelectRows = (\d+);",
                             r"kSelectCols = (\d+);")
    k6_staged = staged_bytes(occ.amax(dim=0), grid, select_tile, 1, 1)
    k6_ms, k7_ms = {}, {}
    for code_dtype in (torch.int32, torch.int8):
        k6 = lambda: reslot.select_cuda(s.xd, s.yd, grid, occ, code_dtype)
        t6 = lambda: reslot.select_torch(s.xd, s.yd, grid, occ, code_dtype)
        (code, cnt), (wcode, wcnt) = k6(), t6()
        check(code.dtype == code_dtype and torch.equal(code, wcode)
              and torch.equal(cnt, wcnt),
              f"K6 select ({code_dtype}) not bitwise equal to its twin")
        for plane, fill in zip(planes, fills):
            g7 = reslot.apply_code_cuda(plane, code, occ, grid, fill)
            w7 = reslot.apply_code_torch(plane, code, occ, grid, fill)
            check(g7.dtype == plane.dtype and torch.equal(g7, w7),
                  f"K7 apply ({plane.dtype} payload, {code_dtype} code) not "
                  f"bitwise equal to its twin")
        code_b = code.element_size() * float(code.numel())
        k7 = lambda: reslot.apply_code_cuda(s.xd, code, occ, grid, 1e9)
        k6_ms[code_dtype] = dict(
            ms=kernel_ms(k6, "select_kernel", 50), wrapper_ms=cuda_ms(k6, 50),
            plain_ms=cuda_ms(t6, 3),
            **bound(k6_xy_b + code_b + cnt_b + occ_b, cand * RESLOT_OPS))
        k7_ms[code_dtype] = dict(
            ms=kernel_ms(k7, "apply_code_kernel", 50),
            wrapper_ms=cuda_ms(k7, 50),
            plain_ms=cuda_ms(lambda: reslot.apply_code_torch(
                s.xd, code, occ, grid, 1e9), 3),
            **bound(2 * plane_b + code_b + occ_b, 0.0))   # moves words only
        print(f"# phase 11: K6 select and K7 apply with {code_dtype} codes "
              f"on the 1M planes ({to_need} steps past phase 4, trigger "
              f"fired): bitwise equal to their twins (5 payload planes); K6 "
              f"{k6_ms[code_dtype]['ms']:.4f} ms (bound "
              f"{k6_ms[code_dtype]['bound_ms']:.4f} by "
              f"{k6_ms[code_dtype]['bound_by']}: "
              f"{k6_ms[code_dtype]['bound_bytes'] / 1e6:.1f} MB, x/y below "
              f"the row bounds, codes, counts; the tiles stage x "
              f"{k6_staged / 1e6:.1f} MB, tile {select_tile} + a one-cell "
              f"ring, and y of its live slots), K7 "
              f"{k7_ms[code_dtype]['ms']:.4f} ms (bound "
              f"{k7_ms[code_dtype]['bound_ms']:.4f}) per apply (profiler) "
              f"on {card}", flush=True)
    got = reslot.reslot_planar(*planes, grid)
    want = reslot.reslot_cuda(*planes, grid)
    for name, g_, w_ in zip(("x", "y", "vx", "vy", "idx", "cnt"), got, want):
        check(g_.dtype == w_.dtype and torch.equal(g_, w_),
              f"reslot_planar {name} not bitwise equal to K3")
    kp = lambda: reslot.reslot_planar(*planes, grid)
    planar_dev = device_ms(kp, ["select_kernel", "apply_code_kernel"], 20)
    k3_dev = kernel_ms(lambda: reslot.reslot_cuda(*planes, grid),
                       "reslot_kernel", 20)
    planar_call = cuda_ms(kp, 20)
    k3_call = cuda_ms(lambda: reslot.reslot_cuda(*planes, grid), 20)
    print(f"#   reslot_planar bitwise equal to K3 (six outputs); device time "
          f"K6 + 5 x K7 {sum(planar_dev.values()):.4f} ms "
          f"({planar_dev['select_kernel']:.4f} + "
          f"{planar_dev['apply_code_kernel']:.4f}) vs K3 {k3_dev:.4f} ms "
          f"(profiler); per call {planar_call:.4f} vs {k3_call:.4f} ms (CUDA "
          f"events) on {card}", flush=True)
    print(f"#   K6 at cap {grid.cap}: {select_occ} (registers per thread, "
          f"shared memory bytes per block, blocks per SM)", flush=True)
    for name, src, line, entry, extra in (
            ("select", "select.cu", "bevy_gpu_fluid_tpu/ops/reslot.py:393",
             k6_ms[torch.int32], dict(staged_bytes=k6_staged, **select_occ)),
            ("apply_code", "apply_code.cu",
             "bevy_gpu_fluid_tpu/ops/reslot.py:504", k7_ms[torch.int32], {})):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"bevy_gpu_fluid_tpu_torch/csrc/{src}", replaces=line,
            max_abs_err=0.0, library_ms=None,
            int8_code_ms=(k6_ms if name == "select" else k7_ms)[
                torch.int8]["ms"], **entry, **extra))
    del s, planes, got, want, code, cnt, wcode, wcnt, g7, w7

    # ---- phase 12: the planar Session at 1M --------------------------------
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    fs = vs.Session(state, params, cfg, grid, device=dev)
    ps = vs.Session(state, params, cfg, grid, device=dev, planar_rebin=True)
    del state
    run_ms, run_counts, run_rebins = {}, {}, {}
    for steps in (WARM_STEPS, MAIN_STEPS):
        for label, sess_ in (("fused", fs), ("planar", ps)):
            zero_counts()
            r0 = sess_.sim.rebin_count
            torch.cuda.synchronize()
            start.record()
            sess_.run(steps)
            end.record()
            end.synchronize()
            run_ms[label] = start.elapsed_time(end) / steps
            run_counts[label] = counts()
            run_rebins[label] = sess_.sim.rebin_count - r0
            lc = run_counts[label]
            rb = run_rebins[label]
            want_counts = ((rb, 0, 0) if label == "fused" else (0, rb, 5 * rb))
            check((lc["reslot"], lc["select"], lc["apply_code"])
                  == want_counts, f"{label} Session rebin launches {lc} for "
                  f"{rb} rebins")
    same = sims_equal(fs.sim, ps.sim)
    print(f"# phase 12: planar vs fused Session at 1M, {WARM_STEPS} + "
          f"{MAIN_STEPS} steps in turns: every DenseSim field bitwise equal: "
          f"{same}; rebins {fs.sim.rebin_count - 1} / "
          f"{ps.sim.rebin_count - 1}, overflow {fs.sim.overflow} / "
          f"{ps.sim.overflow}, lost {fs.sim.lost} / {ps.sim.lost}, "
          f"readmitted {fs.readmitted} / {ps.readmitted}; last "
          f"{MAIN_STEPS} steps: fused {run_ms['fused']:.4f} ms/step, planar "
          f"{run_ms['planar']:.4f} ms/step (CUDA events) on {card}; launches "
          f"fused {run_counts['fused']}, planar {run_counts['planar']}",
          flush=True)
    check(same, "planar Session differs from the fused Session")
    check(run_rebins["planar"] >= 2, "no rebins in the planar main path")
    for k in kernels:
        if k["name"] in ("select", "apply_code"):
            k["launches"] = run_counts["planar"][k["name"]]
    # peak memory across one rebin, from a copy of the same sim each time
    while not fs._need(fs.sim):
        fs.sim = fs._pure_step(fs.sim)
    snap = fs.sim
    del fs, ps, need_sim
    rebin_fns = {label: vs.make_step_parts(params, cfg, grid,
                                           n=N_SIDE * N_SIDE,
                                           planar=label == "planar")[1]
                 for label in ("fused", "planar")}
    peak, outs = {}, {}
    for label in ("fused", "planar"):
        sim_ = dataclasses.replace(snap, **{
            f.name: getattr(snap, f.name).clone()
            for f in dataclasses.fields(vs.DenseSim)
            if isinstance(getattr(snap, f.name), torch.Tensor)})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out_ = rebin_fns[label](sim_)
        torch.cuda.synchronize()
        peak[label] = (torch.cuda.max_memory_allocated(),
                       torch.cuda.max_memory_allocated() - base)
        outs[label] = [getattr(out_, f).cpu() for f in
                       ("xd", "yd", "vxd", "vyd", "idx_d", "occ")]
        del sim_, out_
    same = all(torch.equal(a, b) for a, b in zip(outs["fused"],
                                                  outs["planar"]))
    print(f"#   peak device memory across one 1M rebin "
          f"(torch.cuda.max_memory_allocated, reset before each; plane "
          f"{plane_b / 2**20:.2f} MiB): fused {peak['fused'][0] / 2**20:.1f} "
          f"MiB ({peak['fused'][1] / 2**20:+.1f} over the resident set), "
          f"planar {peak['planar'][0] / 2**20:.1f} MiB "
          f"({peak['planar'][1] / 2**20:+.1f}); results bitwise equal: "
          f"{same} on {card}", flush=True)
    check(same, "planar rebin differs from the fused rebin")
    check(peak["planar"][0] < peak["fused"][0],
          f"planar rebin peak {peak['planar']} not below fused {peak['fused']}")
    del snap, outs
    rp = vs.Session(bt.init_grid(3, 3, 0.004, dev), params, rcfg, rgrid,
                    device=dev, planar_rebin=True)
    rp.run(60)
    same = sims_equal(fused_recovery, rp.sim)
    print(f"#   recovery scene planar: suspended {rp.suspended} / "
          f"{fused_recovery.suspended}, readmitted {rp.readmitted} / "
          f"{fused_recovery.readmitted} (planar / fused), planes bitwise "
          f"equal: {same}", flush=True)
    check(same and rp.readmitted >= 1, "planar recovery differs from fused")

    # ---- phase 13: the eager solver and the validator ----------------------
    egrid = grid_solver.default_grid(0.045, -1.0, extent + 1.0,
                                     y_max=extent * 1.1 + 1.0)
    est = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    est, wdiag = cuda_solver.multi_step(est, params, cfg, egrid, EAGER_WARM)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    est, ediag = cuda_solver.multi_step(est, params, cfg, egrid, EAGER_STEPS)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    e_ms = start.elapsed_time(end) / EAGER_STEPS
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (est.x, est.y, est.vx, est.vy, est.rho, est.ax, est.ay))
    print(f"# phase 13: eager K1 + K8 at 1M on {egrid.plane_shape} "
          f"({egrid.n_row_blocks} row blocks), {EAGER_WARM} warm-up + "
          f"{EAGER_STEPS} timed steps: {e_ms:.4f} ms/step (CUDA events; host "
          f"{wall / EAGER_STEPS * 1e3:.4f}) = "
          f"{est.n / e_ms * 1e3 / 1e6:.1f}M particle-steps/s on {card}; max "
          f"overflow {max(wdiag.overflow, ediag.overflow)}; finite {finite}; "
          f"launches {launches}", flush=True)
    check(finite, "eager 1M fields not finite")
    check(launches["density"] == EAGER_STEPS
          and launches["forces"] == EAGER_STEPS,
          f"eager K1/K8 launches {launches} != {EAGER_STEPS} steps")
    check(launches["forces_integrate"] == launches["reslot"]
          == launches["mono_step"] == 0, f"eager path ran K2/K3/K5: "
          f"{launches}")
    # K8 at the eager path's shapes: the planes the next eager step gives
    # it, held against its twin, timed and bounded on the same inputs
    b = bin_particles(est.x, est.y, egrid)
    ep = [to_dense(b, v, f) for v, f in ((est.x, FAR), (est.y, FAR),
                                          (est.vx, 0.0), (est.vy, 0.0))]
    eocc = reslot.block_kmax3(ep[0], egrid)
    erho = cuda_solver.density_cuda(ep[0], ep[1], params, egrid, eocc)
    f8 = (*ep, erho, params, egrid, eocc)
    k8 = lambda: cuda_solver.forces_cuda(*f8)
    t8 = lambda: cuda_solver.forces_torch(*f8)
    got, want = k8(), t8()
    a_err, a_scale = k8_check(got, want, ep[0], "the eager planes")
    forces_entry = dict(
        name="forces", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:296",
        launches=launches["forces"], max_abs_err=a_err,
        ms=kernel_ms(k8, "forces_kernel", 50), wrapper_ms=cuda_ms(k8, 50),
        plain_ms=cuda_ms(t8, 3), library_ms=None,
        **_build.occupancy("forces", egrid.cap),
        **bound_k8(ep[0], eocc, egrid))
    kernels.append(forces_entry)
    print(f"#   K8 forces on the eager planes {egrid.plane_shape} after "
          f"{EAGER_WARM + EAGER_STEPS} steps: max |da| {a_err:.3e} of max "
          f"|a| {a_scale:.1f} (<= 1e-5 rel), dead slots and ghost blocks +0 "
          f"bitwise; kernel {forces_entry['ms']:.4f} ms (profiler), wrapper "
          f"{forces_entry['wrapper_ms']:.4f} ms, twin "
          f"{forces_entry['plain_ms']:.4f} ms, bound "
          f"{forces_entry['bound_ms']:.4f} ms by {forces_entry['bound_by']} "
          f"({forces_entry['bound_bytes'] / 1e6:.1f} MB, "
          f"{forces_entry['bound_ops'] / 1e9:.3f} GFLOP); the tiles stage "
          f"{staged_bytes(eocc.amax(dim=0), egrid, k8_tile, 1, 5) / 1e6:.1f} "
          f"MB and write 2 planes; live share "
          f"{float((ep[0] < 5e8).float().mean()):.4f} on {card}", flush=True)
    del b, ep, eocc, erho, f8, got, want
    # where an eager step's time goes: device time by operation over a
    # few steps, and the device's busy share of the wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est, _ = cuda_solver.multi_step(est, params, cfg, egrid, 5)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5

    def per_step(e, attr):
        return (getattr(e, attr, 0) or 0) / 1e3 / 5
    kern = sorted((per_step(e, "device_time_total"), e.count // 5,
                   e.key.replace("(anonymous namespace)::", "")
                   .split("(")[0][-48:])
                  for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA)
    ops = sorted((per_step(e, "self_device_time_total"), e.count // 5, e.key)
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CPU
                 and per_step(e, "self_device_time_total") > 0)
    busy = sum(k[0] for k in kern)
    print(f"#   eager step breakdown (torch.profiler, 5 steps): device busy "
          f"{busy:.4f} of {wall_ms:.4f} ms/step wall ({busy / wall_ms:.0%}); "
          f"device time per step by op: " + "; ".join(
              f"{k} {ms:.4f} ms x{c}" for ms, c, k in ops[::-1][:8])
          + "; by kernel: " + "; ".join(
              f"{k} {ms:.4f} ms x{c}" for ms, c, k in kern[::-1][:8]),
          flush=True)
    del est
    for solver in ("pallas", "xla"):
        fsim = bt.Simulation.dam_break(solver=solver, device=dev)
        img = fsim.run_frame(FRAME_SUBSTEPS)
        lit = bool((img.int().sum(-1) > 30).any())
        psim = bt.Simulation.dam_break(solver=solver, device=dev)
        psim.run(10)
        a = psim.state
        rho_rel = float(((a.rho - g.rho).abs() / g.rho).max())
        p_abs = float((a.p - g.p).abs().max())
        dx = max(float((a.x - g.x).abs().max()),
                 float((a.y - g.y).abs().max()))
        dv = max(float((a.vx - g.vx).abs().max()),
                 float((a.vy - g.vy).abs().max()))
        print(f"#   Simulation(solver={solver!r}), 5,041 particles: "
              f"{FRAME_SUBSTEPS}-step splat frame {tuple(img.shape)} lit: "
              f"{lit}; parity vs golden after 10 steps: rho {rho_rel:.3e} "
              f"(<= 3e-3), p {p_abs:.3e} (<= 30), |dx| {dx:.3e} "
              f"(<= 5.18e-4), |dv| {dv:.3e} (<= 0.2456); overflow "
              f"{psim.overflow}", flush=True)
        check(lit, f"{solver}: black frame")
        check(psim.overflow == 0 and rho_rel <= 0.003 and p_abs <= 30.0
              and dx <= 0.000518 and dv <= 0.245602,
              f"{solver}: golden parity bars")
    vsim = bt.Simulation.dam_break(device=dev, validate_every=VALIDATE_EVERY)
    reports = []
    for _ in range(64 // VALIDATE_EVERY):
        vsim.run(VALIDATE_EVERY)
        reports.append(vsim.last_parity)
    fields = vsim.validate(mode="fields")
    last = vsim.last_parity
    print(f"#   Simulation.dam_break(validate_every={VALIDATE_EVERY}) on the "
          f"verlet solver, 64 steps: {len(set(map(id, reports)))} checks, "
          f"last {last}; validate(mode='fields'): {fields}", flush=True)
    check(last is not None and len(set(map(id, reports))) == 4,
          "validate_every did not run every 16 steps")
    check(last.rho_max_rel <= validator.REL_TOL
          and last.p_max_rel <= validator.REL_TOL
          and (last.acc_max_rel <= validator.REL_TOL
               or last.acc_max_abs <= validator.ACC_ABS_TOL)
          and last.acc_max_abs > 0.0, f"in-engine parity {last}")

    return kernels, card

def counter_wrappers() -> dict:
    """Launch counters by kernel-table name: (wrapper, counter attribute).
    The refless K2 counts in its own attribute besides K2's, and so do its
    form with a lane window and K1 into a given plane; the K8 row of the
    slab path reads K8's own counter in a run of that path alone."""
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.ops import reslot
    from bevy_gpu_fluid_tpu_torch.render import raster
    k2 = cuda_solver.forces_integrate_cuda
    return {"density": (cuda_solver.density_cuda, "launches"),
            "forces_integrate": (k2, "launches"),
            "forces_integrate_refless": (k2, "launches_refless"),
            "forces_integrate_lanes": (k2, "launches_lanes"),
            "forces_integrate_refless_lanes": (k2, "launches_refless_lanes"),
            "density_out_slab": (cuda_solver.density_cuda, "launches_out"),
            "forces_slab": (cuda_solver.forces_cuda, "launches"),
            "reslot": (reslot.reslot_cuda, "launches"),
            "reslot_clip": (reslot.reslot_cuda, "launches_clip"),
            "select_clip": (reslot.select_cuda, "launches_clip"),
            "field_raster": (raster.field_density_cuda, "launches"),
            "mono_step": (cuda_solver.mono_step_cuda, "launches"),
            "forces": (cuda_solver.forces_cuda, "launches"),
            "select": (reslot.select_cuda, "launches"),
            "apply_code": (reslot.apply_code_cuda, "launches")}


def zero_launches() -> None:
    for fn, attr in counter_wrappers().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {k: getattr(fn, attr)
            for k, (fn, attr) in counter_wrappers().items()}


def scale_scene(side: int):
    """tools/bench_scale.py's scene for side x side particles: (params,
    cfg, grid) of its box, skin 1.75."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    extent = side * 0.04
    return (bt.FluidParams.demo(),
            bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0),
            vs.default_grid(0.045, -1.0, extent + 1.0,
                            y_max=extent * 1.1 + 1.0, skin_factor=1.75))


def plane_bytes(grid) -> int:
    return 4 * grid.ny_pad * grid.cap * grid.nx_pad


def capacity(footprints: float, total: int, reserve: int) -> int:
    """The largest particle count n = side^2 of the scale scene whose
    ``footprints`` planes fit ``total`` bytes less ``reserve``."""
    lo, hi = 64, 1 << 17
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = footprints * plane_bytes(scale_scene(mid)[2]) + reserve <= total
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo * lo


def planes_sane(sim, cfg, rows: int = 512) -> dict:
    """Slab by slab over the rows: the live slots' count, whether every
    live field is finite and the positions lie in the box (x in [x_min,
    x_max], y >= the floor), and whether the dead slots hold FAR."""
    live_n, ok, dead_far = 0, True, True
    for r in range(0, sim.xd.shape[0], rows):
        x, y = sim.xd[r:r + rows], sim.yd[r:r + rows]
        live = x < 5e8
        live_n += int(live.sum())
        fields = torch.stack([x[live], y[live], sim.vxd[r:r + rows][live],
                              sim.vyd[r:r + rows][live]])
        ok &= bool(torch.isfinite(fields).all()
                   & (fields[0] >= float(cfg.x_min)).all()
                   & (fields[0] <= float(cfg.x_max)).all()
                   & (fields[1] >= float(cfg.floor_y)).all())
        dead_far &= bool((x[~live] == 1e9).all() & (y[~live] == 1e9).all())
    return dict(live=live_n, finite_in_box=ok, dead_far=dead_far)


def ceiling_mechanisms_1m(kernels: list, card: str) -> None:
    """Phase 15: the memory ceiling's mechanisms on phase 4's 1M scene."""
    import tempfile

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.kernels import _build
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs

    dev = torch.device("cuda", 0)
    params = bt.FluidParams.demo()
    extent = N_SIDE * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0)
    grid = vs.default_grid(0.045, -1.0, extent + 1.0,
                           y_max=extent * 1.1 + 1.0)
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)

    want = vs.init_dense(state, grid)
    gen = vs.init_dense_gen(bt.lattice_gen(N_SIDE, 0.04, dev), state.n,
                            grid, 16, device=dev)
    chunked = vs.init_dense_chunked(state, grid, 16)
    same_gen, same_chunked = sims_equal(want, gen), sims_equal(want, chunked)
    print(f"# phase 15: init_dense_gen(lattice_gen) and init_dense_chunked "
          f"(16 chunks) bitwise init_dense at 1M: {same_gen}, "
          f"{same_chunked}", flush=True)
    check(same_gen and same_chunked, "chunked/generator init not bitwise")
    del want, gen, chunked

    # K2 refless and K1 out= on the planes of a refless Session after
    # WARM_STEPS steps
    rs = vs.Session(state, params, cfg, grid, device=dev,
                    refless_trigger=True)
    rs.run(WARM_STEPS)
    s = rs.sim
    live = s.xd < 5e8
    rho = cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ)
    out = torch.full_like(s.xd, float("nan"))
    got = cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ, out=out)
    k1_out = got is out and bits_equal(got, rho)
    check(k1_out, "K1 with out= differs from K1 without it")
    fargs = (s.xd, s.yd, s.vxd, s.vyd, rho)
    k2r = lambda: cuda_solver.forces_integrate_cuda(
        *fargs, None, None, params, cfg, grid, s.occ, refless=True)
    t2r = lambda: cuda_solver.forces_integrate_torch(
        *fargs, None, None, params, cfg, grid, s.occ, refless=True)
    got, want = k2r(), t2r()
    as_k2 = cuda_solver.forces_integrate_cuda(*fargs, s.xd, s.yd, params,
                                              cfg, grid, s.occ)
    same_k2 = all(bits_equal(a, b) for a, b in zip(got, as_k2))
    ddx, ddy = got[0] - s.xd, got[1] - s.yd
    own_max = bits_equal(got[4], (ddx * ddx + ddy * ddy)[live].max())
    pos_err = max(float((g - w).abs().max()) for g, w in zip(got[:2],
                                                             want[:2]))
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    vel_err = max(float((g - w).abs().max())
                  for g, w in zip(got[2:4], want[2:4]))
    d_err = abs(float(got[4]) - float(want[4]))
    dead = ~live
    dead_same = (torch.equal(got[0][dead], s.xd[dead])
                 and torch.equal(got[1][dead], s.yd[dead])
                 and bool((got[2][dead] == 0).all()
                          & (got[3][dead] == 0).all()))
    print(f"#   K2 refless on the 1M planes after {WARM_STEPS} refless "
          f"steps: outputs and displacement max bitwise K2's with the old "
          f"positions as reference: {same_k2}; max bitwise the max over "
          f"its own outputs: {own_max}; against its twin |dx| "
          f"{pos_err:.3e} (<= 1e-5), |dv| {vel_err:.3e} of max|v| "
          f"{vscale:.3f} (<= 1e-4 rel), step max {float(got[4]):.6e} vs "
          f"{float(want[4]):.6e}; dead slots bitwise: {dead_same}; K1 "
          f"out= bitwise: {k1_out}", flush=True)
    check(same_k2 and own_max, "K2 refless not bitwise K2 with ref = x")
    check(pos_err <= 1e-5 and vel_err <= 1e-4 * vscale
          and d_err <= 1e-4 * float(want[4]) and dead_same,
          "K2 refless against its twin")
    plane_b = 4.0 * s.xd.numel()
    need_taps, _ = tile_taps(s.xd, s.occ, grid)
    occ_refless = _build.occupancy("forces_integrate_refless", grid.cap)
    check(occ_refless["local_bytes"] == 0, "K2 refless spills")
    row = dict(
        name="forces_integrate_refless", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:626",
        launches=None, max_abs_err=max(pos_err, vel_err, d_err),
        ms=kernel_ms(k2r, "forces_integrate_kernel<true>", 50),
        wrapper_ms=cuda_ms(k2r, 50), plain_ms=cuda_ms(t2r, 3),
        library_ms=None, **occ_refless,
        # two planes fewer than K2: no reference planes
        **bound(9 * plane_b + 4.0 * s.occ.numel() + 4,
                need_taps * FORCE_OPS + float(live.sum()) * 20))
    k2_ms = kernel_ms(lambda: cuda_solver.forces_integrate_cuda(
        *fargs, s.xd, s.yd, params, cfg, grid, s.occ),
        "forces_integrate_kernel<false>", 50)
    kernels.append(row)
    print(f"#   K2 refless: kernel {row['ms']:.4f} ms (profiler; ref-based "
          f"K2 {k2_ms:.4f} on the same planes), wrapper "
          f"{row['wrapper_ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bound_bytes'] / 1e6:.1f} MB, "
          f"{row['bound_ops'] / 1e9:.3f} GFLOP); {occ_refless} on {card}",
          flush=True)
    del s, rs, live, rho, out, got, want, as_k2, ddx, ddy, dead, fargs

    # the segmented driver against the standard one, and refless against
    # ref-based, from the same state
    runs = {}
    for label, kw, chunk, steps in (
            ("standard", {}, None, SEGMENTED_STEPS),
            ("segmented", dict(segmented=True), None, SEGMENTED_STEPS),
            ("segmented chunk=50", dict(segmented=True), 50,
             SEGMENTED_STEPS),
            ("ref-based 120", {}, None, REFLESS_STEPS),
            ("refless 120", dict(refless_trigger=True), None,
             REFLESS_STEPS)):
        sess = vs.Session(state, params, cfg, grid, device=dev, **kw)
        sess.run(steps, chunk=chunk)
        runs[label] = sess
    seg = [sims_equal(runs["standard"].sim, runs[k].sim)
           for k in ("segmented", "segmented chunk=50")]
    a, b = runs["ref-based 120"], runs["refless 120"]
    dx = float((a.state().x - b.state().x).abs().max())
    print(f"#   segmented Session, without and with chunk=50, bitwise the "
          f"standard one over {SEGMENTED_STEPS} steps at 1M: {seg} "
          f"({runs['standard'].sim.rebin_count - 1} rebins); refless vs "
          f"ref-based over {REFLESS_STEPS} steps: |dx| {dx:.3e} (<= 5e-5), "
          f"rebins {b.sim.rebin_count - 1} >= {a.sim.rebin_count - 1}, "
          f"overflow {b.overflow} / {a.overflow}", flush=True)
    check(all(seg), "segmented Session differs from the standard one")
    check(dx <= 5e-5 and b.sim.rebin_count >= a.sim.rebin_count
          and a.overflow == b.overflow == 0, "refless vs ref-based")
    del runs, a, b

    # checkpoint round trips, default and refless
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for posture, kw, other in (("default", {}, True),
                                   ("refless", dict(refless_trigger=True),
                                    False)):
            path = os.path.join(tmp, posture)
            a = vs.Session(state, params, cfg, grid, device=dev, **kw)
            a.run(RESTORE_STEPS)
            a.save(path)
            a.run(RESTORE_STEPS)
            b = vs.Session.restore(path, device=dev, **kw)
            b.run(RESTORE_STEPS)
            same = sims_equal(a.sim, b.sim)
            try:
                vs.Session.restore(path, device=dev, refless_trigger=other)
                refused = False
            except ValueError:
                refused = True
            print(f"#   {posture} Session.save -> restore -> "
                  f"{RESTORE_STEPS} steps bitwise an uninterrupted run: "
                  f"{same} ({a.sim.rebin_count - 1} rebins, "
                  f"{os.path.getsize(path + '.npz') / 2**20:.1f} MiB); "
                  f"restore with refless_trigger={other} refused: "
                  f"{refused}", flush=True)
            check(same and refused, f"{posture} checkpoint round trip")
            del a, b
        fsim = bt.Simulation.dam_break(device=dev)
        fsim.run(20)
        path = os.path.join(tmp, "sim")
        fsim.save(path)
        gsim = bt.Simulation.dam_break(device=dev)
        gsim.load(path)
        fa, fb = fsim.state, gsim.state
        same = fa.step == fb.step == 20 and all(
            torch.equal(getattr(fa, f), getattr(fb, f))
            for f in ("x", "y", "vx", "vy"))
        print(f"#   Simulation.save/load round trip, 5,041 particles after "
              f"20 steps: {same}", flush=True)
        check(same, "Simulation.save/load round trip")


def slab_mesh(kernels: list, card: str) -> None:
    """Phase 16: the slab decomposition (``parallel/``) on the one card."""
    import tempfile

    import bevy_gpu_fluid_tpu_torch as bt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.ops.binning import (FAR, bin_particles,
                                                      to_dense)
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession
    from bevy_gpu_fluid_tpu_torch.render import raster

    dev = torch.device("cuda", 0)
    params = bt.FluidParams.demo()
    extent = N_SIDE * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0)
    bounds = dict(h=0.045 * 1.5, x_min=-1.0, x_max=extent + 1.0,
                  y_max=extent * 1.1 + 1.0)
    grid = vs.default_grid(0.045, -1.0, extent + 1.0,
                           y_max=extent * 1.1 + 1.0)
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    n = state.n
    specs = {D: shard.ShardSpec.build(n_devices=D, capacity=n, **bounds)
             for D in SLAB_COUNTS}

    def session(D, **kw):
        return ShardedSession(state, params, cfg, specs[D],
                              SlabMesh([dev] * D), **kw)

    # ---- D = 4 vs D = 2 vs the single-card Session, by idx, over a window
    # in which every run rebins (the collective rebin against the Session's)
    one = vs.Session(state, params, cfg, grid, device=dev)
    steps = 0
    while (one.sim.rebin_count - 1 < SLAB_IDENTITY_REBINS
           and steps < SLAB_IDENTITY_MAX):
        one.run(SLAB_IDENTITY_CHUNK)
        steps += SLAB_IDENTITY_CHUNK
    ref = one.state()
    ident = {}
    for D in (2, 4):
        sess = session(D)
        sess.run(steps)
        ident[D] = (sess.state(), sess.rebin_count - 1)
    rebins = (ident[2][1], ident[4][1], one.sim.rebin_count - 1)
    pairs = (("D=4 vs D=2", ident[4][0], ident[2][0]),
             ("D=2 vs one card", ident[2][0], ref),
             ("D=4 vs one card", ident[4][0], ref))
    for label, a, b in pairs:
        dx = max(float((a.x - b.x).abs().max()),
                 float((a.y - b.y).abs().max()))
        dv = max(float((a.vx - b.vx).abs().max()),
                 float((a.vy - b.vy).abs().max()))
        print(f"# phase 16: {label} after {steps} steps at 1M (rebins D=2 "
              f"{rebins[0]}, D=4 {rebins[1]}, one card {rebins[2]}), per "
              f"particle by idx: max |dx| {dx:.3e} (<= 1e-6), max |dv| "
              f"{dv:.3e} (<= 1e-4)", flush=True)
        check(dx <= 1e-6 and dv <= 1e-4,
              f"slab identity {label}: dx {dx} dv {dv}")
    check(min(rebins) >= SLAB_IDENTITY_REBINS,
          f"slab identity window holds rebins {rebins}")
    del one, ident, ref, pairs, a, b

    # ---- the timed runs at D = 1, 2, 4; the variants on a D = 2 slab
    runs = {}
    for D in SLAB_COUNTS:
        sess = session(D)
        sess.run(WARM_STEPS)
        torch.cuda.synchronize()
        snap = sess.sim           # the steps and rebins make new tensors
        if D == 2:
            variants_on_slab(kernels, card, sess, params, cfg)
            sess.sim = snap
        zero_launches()
        rebins0 = sess.rebin_count
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        sess.run(MAIN_STEPS)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        rebins = sess.rebin_count - rebins0
        ms = start.elapsed_time(end) / MAIN_STEPS
        ids = torch.cat([a[:, :, 1:specs[D].nx_local + 1].reshape(-1)
                         for a in sess.sim.idx_d] + list(sess.sim.sidx))
        ids = torch.sort(ids[ids >= 0]).values
        once = ids.numel() == n and torch.equal(
            ids, torch.arange(n, dtype=ids.dtype, device=ids.device))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sess.run(BREAKDOWN_STEPS)
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((e.device_time_total / 1e3 / BREAKDOWN_STEPS, e.count,
              e.key.replace("(anonymous namespace)::", "")
              .replace("void ", "").split("(")[0].split("<")[0][-40:])
             for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.device_time_total > 0), reverse=True)
        busy = sum(k[0] for k in by_kernel)
        runs[D] = dict(ms=ms, rebins=rebins, launches=launches)
        print(f"# phase 16: ShardedSession D={D} ({D} slabs of "
              f"{specs[D].local_grid.plane_shape} on cuda:0), "
              f"{WARM_STEPS} + {MAIN_STEPS} steps: {ms:.4f} ms/step (CUDA "
              f"events; host {wall / MAIN_STEPS * 1e3:.4f}) = "
              f"{n / ms * 1e3 / 1e6:.1f}M particle-steps/s on {card}; "
              f"rebins {rebins}; overflow {sess.overflow}, dropped "
              f"{sess.dropped}, lost {sess.lost}, alive {sess.alive}; every "
              f"idx once: {once}; launches per slab K1 "
              f"{launches['density'] / D:g}, K2 "
              f"{launches['forces_integrate_lanes'] / D:g} (with the lane "
              f"window), K3 {launches['reslot_clip'] / D:g} (with the "
              f"clip); all {launches}; breakdown over "
              f"{BREAKDOWN_STEPS} steps: busy {busy:.4f} ms/step, idle "
              f"share {1 - busy / ms:.3f}; " + "; ".join(
                  f"{name} {t:.4f} ms x{c}" for t, c, name in by_kernel[:6]),
              flush=True)
        check(sess.overflow == sess.dropped == sess.lost == 0 and once,
              f"D={D}: overflow/dropped/lost or idx")
        check(launches["density"] == D * MAIN_STEPS
              and launches["forces_integrate"] == D * MAIN_STEPS
              and launches["forces_integrate_lanes"] == D * MAIN_STEPS,
              f"D={D}: K1/K2 launches {launches}")
        check(launches["reslot"] == launches["reslot_clip"] == D * rebins
              and rebins >= 2, f"D={D}: K3 launches {launches}, {rebins}")
        check(launches["mono_step"] == launches["select"] == 0,
              f"D={D}: K5/K6 launched {launches}")
        if D == 2:
            for k in kernels:
                if k["name"] in ("forces_integrate_lanes", "reslot_clip"):
                    k["launches"] = launches[k["name"]]
                    k["launches_path"] = (f"D=2 ShardedSession, "
                                          f"{MAIN_STEPS} steps")
            two = sess
        del sess, snap
    print(f"# phase 16: ms/step at 1M on {card}: " + ", ".join(
        f"D={D} {runs[D]['ms']:.4f}" for D in SLAB_COUNTS)
        + " (D slabs on one card: no gain is claimed)", flush=True)

    # ---- planar vs fused at D = 2, from the same state
    fused = session(2)
    fused.run(WARM_STEPS)
    zero_launches()
    planar = session(2, planar_rebin=True)
    planar.run(WARM_STEPS)
    launches = read_launches()
    rb = planar.rebin_count - 1
    same = slab_sims_equal(fused.sim, planar.sim)
    print(f"# phase 16: planar ShardedSession D=2 bitwise the fused one "
          f"after {WARM_STEPS} steps: {same} ({rb} rebins; launches "
          f"K6 {launches['select']} K6 clip {launches['select_clip']} K7 "
          f"{launches['apply_code']} K3 {launches['reslot']})", flush=True)
    check(same and rb >= 2, "planar sharded rebin vs fused")
    check(launches["select"] == launches["select_clip"] == 2 * rb
          and launches["apply_code"] == 10 * rb
          and launches["reslot"] == 0, f"planar launches {launches}")
    for k in kernels:
        if k["name"] == "select_clip":     # K6 runs on the planar path
            k["launches"] = launches["select_clip"]
            k["launches_path"] = (f"planar D=2 ShardedSession, "
                                  f"{WARM_STEPS} steps")
    del fused, planar

    # ---- a frame across both slabs vs the single-card frame
    zero_launches()
    img = two.frame()
    k4 = read_launches()["field_raster"]
    fs = two.state()
    gg = specs[2].global_grid()
    b = bin_particles(fs.x, fs.y, gg)
    img1 = raster.field_frame(to_dense(b, fs.x, FAR), to_dense(b, fs.y, FAR),
                              params, gg)
    diff = (img.int() - img1.int()).abs()
    wet = img.int().sum(-1) > 10
    half = img.shape[1] // 2
    seam = bool(wet[:, half - 1].any() and wet[:, half].any())
    eq = float((diff == 0).float().mean())
    print(f"# phase 16: frame of the D=2 session {tuple(img.shape)} vs the "
          f"single-card frame of its particles: max |du8| "
          f"{int(diff.max())} (<= 1), equal {eq:.5f} (>= 0.99), wet on "
          f"both sides of the seam: {seam}; K4 launches {k4}", flush=True)
    check(img.shape == img1.shape and int(diff.max()) <= 1 and eq >= 0.99
          and seam and k4 == 2, "sharded frame")

    # ---- save -> restore -> 100 steps, bitwise
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "slabs")
        two.save(path)
        two.run(RESTORE_STEPS)
        back = ShardedSession.restore(path, SlabMesh([dev] * 2))
        back.run(RESTORE_STEPS)
        same = slab_sims_equal(two.sim, back.sim)
        print(f"# phase 16: ShardedSession.save -> restore -> "
              f"{RESTORE_STEPS} steps bitwise an uninterrupted run: {same} "
              f"({os.path.getsize(path + '.npz') / 2**20:.1f} MiB)",
              flush=True)
        check(same, "sharded checkpoint round trip")
    del two, back


def variants_on_slab(kernels: list, card: str, sess, params, cfg) -> None:
    """Phase 16's kernel variants on slab d of a D = 2 ShardedSession's 1M
    planes at the step where its rebin trigger next fires: K2 with the
    slab's lane window on the planes its step gives K2 (after the halo
    fill and K1), K3 and K6 with the slab's clip and origin on the planes
    its rebin gives them (ghost x and idx cleared)."""
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.ops import reslot
    from bevy_gpu_fluid_tpu_torch.parallel import shard

    steps = sess._steps
    to_need = 0
    while not steps.need(sess.sim):
        sess.sim = steps.pure_step(sess.sim)
        to_need += 1
    spec, sim = sess.spec, sess.sim
    g, nxl, d = spec.local_grid, spec.nx_local, 1
    plane_b = 4.0 * g.ny_pad * g.cap * g.nx_pad
    occ = sim.occ[d]
    occ_b = 4.0 * occ.numel()
    # K2 with the lane window, on the planes the step gives it
    halo = shard.fill_ghost_cols_multi(
        sess.mesh, list(zip(sim.xd, sim.yd, sim.vxd, sim.vyd)), nxl,
        (1e9, 1e9, 0.0, 0.0))[d]
    rho = cuda_solver.density_cuda(halo[0], halo[1], params, g, occ)
    args = (*halo, rho, sim.ref_xd[d], sim.ref_yd[d], params, cfg, g, occ)
    lanes = (1, nxl + 1)
    k2 = lambda: cuda_solver.forces_integrate_cuda(*args, disp_lanes=lanes)
    t2 = lambda: cuda_solver.forces_integrate_torch(*args, disp_lanes=lanes)
    got, full, want = k2(), cuda_solver.forces_integrate_cuda(*args), t2()
    same = all(bits_equal(a, b) for a, b in zip(got[:4], full[:4]))
    live = (halo[0] < 5e8)[:, :, 1:nxl + 1]
    ddx = (got[0] - sim.ref_xd[d])[:, :, 1:nxl + 1]
    ddy = (got[1] - sim.ref_yd[d])[:, :, 1:nxl + 1]
    own_max = torch.where(live, ddx * ddx + ddy * ddy, 0.0).amax()
    pos_err = max(float((a - b).abs().max()) for a, b in zip(got[:2],
                                                             want[:2]))
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    vel_err = max(float((a - b).abs().max()) for a, b in zip(got[2:4],
                                                             want[2:4]))
    d_err = abs(float(got[4]) - float(want[4]))
    print(f"# phase 16: K2 with slab {d}'s lane window {lanes} on its 1M "
          f"planes {g.plane_shape} ({to_need} steps to the next rebin): "
          f"planes bitwise K2 without it: {same}; its max bitwise the max "
          f"over its own outputs in the window: "
          f"{bits_equal(got[4], own_max)}; vs twin |dx| {pos_err:.3e}, "
          f"|dv| {vel_err:.3e} of {vscale:.3f}, disp2 {float(got[4]):.6e} "
          f"vs {float(want[4]):.6e} (full plane {float(full[4]):.6e})",
          flush=True)
    check(same and bits_equal(got[4], own_max), "K2 lane window bitwise")
    check(pos_err <= 1e-5 and vel_err <= 1e-4 * vscale
          and d_err <= 1e-4 * float(want[4]), "K2 lane window vs twin")
    need_taps, _ = tile_taps(halo[0], occ, g)
    n_live = float((halo[0] < 5e8).sum())
    kernels.append(dict(
        name="forces_integrate_lanes", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
        replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:646",
        max_abs_err=max(pos_err, vel_err, d_err),
        ms=kernel_ms(k2, "forces_integrate_kernel", 50),
        wrapper_ms=cuda_ms(k2, 50), plain_ms=cuda_ms(t2, 3),
        library_ms=None, shape=list(g.plane_shape),
        **bound(11 * plane_b + occ_b + 4,
                need_taps * FORCE_OPS + n_live * 20)))
    del got, full, want, halo, rho, args
    # K3 and K6 with the clip and origin, on the planes the rebin gives them
    xd = sim.xd[d].clone()
    xd[:, :, 0] = 1e9
    xd[:, :, nxl + 1] = 1e9
    idx = sim.idx_d[d].clone()
    idx[:, :, 0] = -1
    idx[:, :, nxl + 1] = -1
    planes = (xd, sim.yd[d], sim.vxd[d], sim.vyd[d], idx)
    cell = dict(clip_lo=-1, clip_hi=nxl, origin=shard.slab_origin(spec, d))
    k3 = lambda: reslot.reslot_cuda(*planes, g, **cell)
    t3 = lambda: reslot.reslot_torch(*planes, g, **cell)
    got, want = k3(), t3()
    same3 = all(a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want))
    capt = int((got[0][:, :, 0] < 5e8).sum()
               + (got[0][:, :, nxl + 1] < 5e8).sum())
    kocc = reslot.block_kmax3(xd, g)
    k6 = lambda: reslot.select_cuda(xd, sim.yd[d], g, kocc, torch.int32,
                                    **cell)
    t6 = lambda: reslot.select_torch(xd, sim.yd[d], g, kocc, torch.int32,
                                     **cell)
    (code, cnt), (wcode, wcnt) = k6(), t6()
    same6 = torch.equal(code, wcode) and torch.equal(cnt, wcnt)
    planar = reslot.reslot_planar(*planes, g, torch.int32, **cell)
    same_p = all(torch.equal(a, b) for a, b in zip(planar, got))
    # the same planes with every live x nudged by up to +-0.05 (of a
    # 0.0675 cell): particles cross both slab edges into the captures
    gen = torch.Generator(device=xd.device).manual_seed(16)
    nudge = (torch.rand(xd.shape, generator=gen, device=xd.device) - 0.5) * 0.1
    xn = torch.where(xd < 5e8, xd + nudge, xd)
    nplanes = (xn, *planes[1:])
    ngot = reslot.reslot_cuda(*nplanes, g, **cell)
    nwant = reslot.reslot_torch(*nplanes, g, **cell)
    nocc = reslot.block_kmax3(xn, g)
    nsel = reslot.select_cuda(xn, sim.yd[d], g, nocc, torch.int8, **cell)
    nsel_t = reslot.select_torch(xn, sim.yd[d], g, nocc, torch.int8, **cell)
    nplanar = reslot.reslot_planar(*nplanes, g, torch.int8, **cell)
    same_n = (all(torch.equal(a, b) for a, b in zip(ngot, nwant))
              and all(torch.equal(a, b) for a, b in zip(nsel, nsel_t))
              and all(torch.equal(a, b) for a, b in zip(nplanar, ngot)))
    ncapt = [int((ngot[0][:, :, lane] < 5e8).sum()) for lane in (0, nxl + 1)]
    print(f"# phase 16: K3 with slab {d}'s clip [-1, {nxl}] and origin "
          f"{float(cell['origin'][0]):.6f}: bitwise its twin: {same3}; "
          f"{capt} particles captured in the ghost columns; K6 (int32 "
          f"codes) bitwise its twin: {same6}; reslot_planar bitwise K3: "
          f"{same_p}; x nudged by up to 0.05: K3, K6 (int8) and the "
          f"planar rebin bitwise: {same_n}, captures left/right {ncapt} "
          f"(slab 1 of 2: only its left edge is a seam)",
          flush=True)
    check(same3 and same6 and same_p and same_n and sum(ncapt) > 0,
          "K3/K6 clip and origin bitwise")
    del ngot, nwant, nsel, nsel_t, nplanar, xn, nplanes
    rows = row_bounds(kocc.amax(dim=0), g)
    cand = 9.0 * g.nx_pad * float(rows.sum())
    cnt_b = 4.0 * g.ny_pad * g.nx_pad
    xy_b = 2 * 4.0 * g.nx_pad * read_slots(rows, g.row_block,
                                           g.ny_pad - g.row_block)
    kernels.append(dict(
        name="reslot_clip", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/reslot.cu",
        replaces="bevy_gpu_fluid_tpu/ops/reslot.py:203", max_abs_err=0.0,
        ms=kernel_ms(k3, "reslot_kernel", 20), wrapper_ms=cuda_ms(k3, 20),
        plain_ms=cuda_ms(t3, 3), library_ms=None, shape=list(g.plane_shape),
        **bound(10 * plane_b + occ_b + cnt_b, cand * RESLOT_OPS)))
    kernels.append(dict(
        name="select_clip", route="cuda",
        source="bevy_gpu_fluid_tpu_torch/csrc/select.cu",
        replaces="bevy_gpu_fluid_tpu/ops/reslot.py:393", max_abs_err=0.0,
        ms=kernel_ms(k6, "select_kernel", 50), wrapper_ms=cuda_ms(k6, 50),
        plain_ms=cuda_ms(t6, 3), library_ms=None, shape=list(g.plane_shape),
        **bound(xy_b + 4.0 * code.numel() + cnt_b + occ_b,
                cand * RESLOT_OPS)))
    for k in kernels[-3:]:
        print(f"#   {k['name']}: kernel {k['ms']:.4f} ms (profiler), wrapper "
              f"{k['wrapper_ms']:.4f} ms, twin {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bound_bytes'] / 1e6:.1f} MB, "
              f"{k['bound_ops'] / 1e9:.3f} GFLOP) at {g.plane_shape} on "
              f"{card}", flush=True)


def busy_ms(sess, steps: int) -> tuple[float, float]:
    """(ms/step by CUDA events, device busy ms/step by torch.profiler) of
    ``steps`` more steps of a session, each over its own run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sess.run(steps)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.run(BREAKDOWN_STEPS)
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA)
    return ms, busy / 1e3 / BREAKDOWN_STEPS


def sharded_postures_1m(kernels: list, card: str) -> None:
    """Phase 17 (a) and (b): the sharded very-large-N postures at D = 2 on
    phase 4's 1M scene: the kernel variants they put on slab planes, then
    each posture against the one it must equal or approach."""
    import tempfile

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession

    dev = torch.device("cuda", 0)
    params = bt.FluidParams.demo()
    extent = N_SIDE * 0.04
    cfg = bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0)
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0,
                                 x_max=extent + 1.0, y_max=extent * 1.1 + 1.0,
                                 n_devices=2, capacity=N_SIDE * N_SIDE)
    state = bt.init_grid(N_SIDE, N_SIDE, 0.04, dev)
    n = state.n
    mesh = SlabMesh([dev] * 2)
    g, nxl = spec.local_grid, spec.nx_local

    def session(**kw):
        return ShardedSession(state, params, cfg, spec, mesh, **kw)

    def ids_once(sess) -> bool:
        ids = torch.cat([a[:, :, 1:nxl + 1].reshape(-1)
                         for a in sess.sim.idx_d] + list(sess.sim.sidx))
        ids = torch.sort(ids[ids >= 0]).values
        return ids.numel() == n and torch.equal(
            ids, torch.arange(n, dtype=ids.dtype, device=ids.device))

    # ---- (a) the variants on slab 1's planes of a refless D = 2 session
    rs = session(refless_trigger=True)
    rs.run(WARM_STEPS)
    sim, d = rs.sim, 1
    occ = sim.occ[d]
    halo = shard.fill_ghost_cols_multi(
        mesh, list(zip(sim.xd, sim.yd, sim.vxd, sim.vyd)), nxl,
        (1e9, 1e9, 0.0, 0.0))[d]
    plane_b = 4.0 * halo[0].numel()
    occ_b = 4.0 * occ.numel()
    live = halo[0] < 5e8
    n_live = float(live.sum())
    need_taps, _ = tile_taps(halo[0], occ, g)
    # K1 with out= on the slab's halo planes
    k1 = lambda: cuda_solver.density_cuda(halo[0], halo[1], params, g, occ)
    dead_rho = torch.full_like(halo[0], float("nan"))
    k1o = lambda: cuda_solver.density_cuda(halo[0], halo[1], params, g, occ,
                                           out=dead_rho)
    t1 = lambda: cuda_solver.density_torch(halo[0], halo[1], params, g, occ)
    rho, rho_t = k1(), t1()
    got = k1o()
    k1_same = got is dead_rho and bits_equal(got, rho)
    k1_rel = float(((rho - rho_t).abs()
                    / rho_t.abs().clamp_min(1e-30)).max())
    # K2 refless with the lane window on the planes the step gives it
    args = (*halo, rho, None, None, params, cfg, g, occ)
    lanes = (1, nxl + 1)
    k2 = lambda: cuda_solver.forces_integrate_cuda(*args, refless=True,
                                                   disp_lanes=lanes)
    t2 = lambda: cuda_solver.forces_integrate_torch(*args, refless=True,
                                                    disp_lanes=lanes)
    out, full, want = (k2(), cuda_solver.forces_integrate_cuda(
        *args, refless=True), t2())
    k2_same = all(bits_equal(a, b) for a, b in zip(out[:4], full[:4]))
    ddx = (out[0] - halo[0])[:, :, 1:nxl + 1]
    ddy = (out[1] - halo[1])[:, :, 1:nxl + 1]
    own_max = torch.where(live[:, :, 1:nxl + 1], ddx * ddx + ddy * ddy,
                          0.0).amax()
    k2_max = bits_equal(out[4], own_max)
    pos_err = max(float((a - b).abs().max()) for a, b in zip(out[:2],
                                                             want[:2]))
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    vel_err = max(float((a - b).abs().max()) for a, b in zip(out[2:4],
                                                             want[2:4]))
    d_err = abs(float(out[4]) - float(want[4]))
    # K8 on the slab's halo planes
    f8 = (*halo, rho, params, g, occ)
    k8 = lambda: cuda_solver.forces_cuda(*f8)
    t8 = lambda: cuda_solver.forces_torch(*f8)
    a_err, a_scale = k8_check(k8(), t8(), halo[0], "a D = 2 slab's planes")
    print(f"# phase 17: variants on slab {d} of a refless D=2 session's 1M "
          f"planes {g.plane_shape} after {WARM_STEPS} steps: K1 out= "
          f"bitwise K1: {k1_same} (vs twin rel {k1_rel:.3e}, <= 1e-5); K2 "
          f"refless with the lane window {lanes}: planes bitwise K2 refless "
          f"over every lane: {k2_same}, its max bitwise the max of its own "
          f"moves in the window: {k2_max}; vs twin |dx| {pos_err:.3e} (<= "
          f"1e-5), |dv| {vel_err:.3e} of {vscale:.3f} (<= 1e-4 rel), step "
          f"max {float(out[4]):.6e} vs {float(want[4]):.6e} (every lane "
          f"{float(full[4]):.6e}); K8 |da| {a_err:.3e} of {a_scale:.1f} "
          f"(<= 1e-5 rel), dead slots +0 bitwise; on {card}", flush=True)
    check(k1_same and k1_rel <= 1e-5, "K1 out= on a slab")
    check(k2_same and k2_max, "K2 refless + lanes bitwise")
    check(pos_err <= 1e-5 and vel_err <= 1e-4 * vscale
          and d_err <= 1e-4 * float(want[4]), "K2 refless + lanes vs twin")
    shape = list(g.plane_shape)
    rows = [
        dict(name="forces_integrate_refless_lanes", route="cuda",
             source="bevy_gpu_fluid_tpu_torch/csrc/forces_integrate.cu",
             replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:626",
             max_abs_err=max(pos_err, vel_err, d_err),
             ms=kernel_ms(k2, "forces_integrate_kernel<true>", 50),
             wrapper_ms=cuda_ms(k2, 50), plain_ms=cuda_ms(t2, 3),
             library_ms=None, shape=shape,
             **bound(9 * plane_b + occ_b + 4,
                     need_taps * FORCE_OPS + n_live * 20)),
        dict(name="density_out_slab", route="cuda",
             source="bevy_gpu_fluid_tpu_torch/csrc/density.cu",
             replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:224",
             max_abs_err=float((got - rho_t).abs().max()),
             ms=kernel_ms(k1o, "density_kernel", 50),
             wrapper_ms=cuda_ms(k1o, 50), plain_ms=cuda_ms(t1, 3),
             library_ms=None, shape=shape,
             **bound(3 * plane_b + occ_b, need_taps * DENSITY_OPS)),
        dict(name="forces_slab", route="cuda",
             source="bevy_gpu_fluid_tpu_torch/csrc/forces.cu",
             replaces="bevy_gpu_fluid_tpu/models/pallas_solver.py:296",
             max_abs_err=a_err, ms=kernel_ms(k8, "forces_kernel", 50),
             wrapper_ms=cuda_ms(k8, 50), plain_ms=cuda_ms(t8, 3),
             library_ms=None, shape=shape, **bound_k8(halo[0], occ, g))]
    kernels.extend(rows)
    for k in rows:
        print(f"#   {k['name']}: kernel {k['ms']:.4f} ms (profiler), wrapper "
              f"{k['wrapper_ms']:.4f} ms, twin {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bound_bytes'] / 1e6:.1f} MB, "
              f"{k['bound_ops'] / 1e9:.3f} GFLOP) at {g.plane_shape} on "
              f"{card}", flush=True)
    del rs, sim, occ, halo, rho, rho_t, got, dead_rho, args, out, full, want
    del ddx, ddy, own_max, f8, live

    # ---- (b) the postures at 1M, D = 2
    runs = {}
    for label, kw in (("ref-based", {}),
                      ("refless", dict(refless_trigger=True))):
        sess = session(**kw)
        sess.run(SHARDED_STEPS)
        runs[label] = sess
    a, b = runs["ref-based"], runs["refless"]
    sa, sb = a.state(), b.state()
    dx = max(float((sa.x - sb.x).abs().max()),
             float((sa.y - sb.y).abs().max()))
    dv = max(float((sa.vx - sb.vx).abs().max()),
             float((sa.vy - sb.vy).abs().max()))
    print(f"# phase 17: refless vs ref-based D=2 over {SHARDED_STEPS} steps "
          f"at 1M: rebins {b.rebin_count - 1} >= {a.rebin_count - 1}, "
          f"overflow {b.overflow} / {a.overflow}, lost {b.lost}, every idx "
          f"once: {ids_once(b)}; |dx| {dx:.3e} (<= 5e-5), |dv| {dv:.3e} "
          f"(<= 5e-3)", flush=True)
    check(b.rebin_count >= a.rebin_count and a.overflow == b.overflow == 0
          and b.lost == 0 and ids_once(b) and dx <= 5e-5 and dv <= 5e-3,
          "sharded refless vs ref-based")
    del sa, sb, a
    # segmented + owned + planar + refless against the standard refless run
    seg = session(refless_trigger=True, planar_rebin=True, donate=True,
                  segmented=True)
    half = SHARDED_STEPS // 2 + 10
    seg.run(half)
    seg.run(SHARDED_STEPS - half, chunk=SHARDED_STEPS // 6)
    same = slab_sims_equal(b.sim, seg.sim)
    print(f"# phase 17: segmented + donate + planar + refless D=2 bitwise "
          f"the standard refless run over {SHARDED_STEPS} steps ({half} + "
          f"{SHARDED_STEPS - half} with chunk={SHARDED_STEPS // 6}): {same} "
          f"({seg.rebin_count - 1} rebins)", flush=True)
    check(same and seg.rebin_count - 1 >= 2, "sharded segmented driver")
    del seg
    # owned planes: the in-place halo (and K1 into the dead rho) against the
    # copying run, refless (every field comparable)
    own = session(refless_trigger=True, donate=True)
    own.run(SHARDED_STEPS)
    same = slab_sims_equal(b.sim, own.sim)
    print(f"# phase 17: in-place halo (donate=True) D=2 bitwise the copying "
          f"one over {SHARDED_STEPS} refless steps: {same}", flush=True)
    check(same, "in-place halo vs copying")
    del own
    # the generator and chunked inits against the sort-based one
    sorted_sim = session().sim
    chunked = session(init_chunks=16).sim
    same_c = slab_sims_equal(sorted_sim, chunked)
    del chunked
    gen = ShardedSession.from_generator(
        bt.lattice_gen(N_SIDE, 0.04, dev), n, params, cfg, spec, mesh,
        init_chunks=16, donate=False)
    same_g = slab_sims_equal(sorted_sim, gen.sim)
    print(f"# phase 17: D=2 init_chunks=16 and from_generator(lattice_gen) "
          f"bitwise the sort-based init at 1M: {same_c}, {same_g}",
          flush=True)
    check(same_c and same_g, "sharded chunked/generator init")
    del sorted_sim, gen
    # the unfused step (K1 + K8 + the torch tail) against the fused one
    fused = session()
    unfused = session(fused=False, stencils=cuda_solver.make_stencils(g))
    fused.run(UNFUSED_STEPS)
    zero_launches()
    unfused.run(UNFUSED_STEPS)
    launches = read_launches()
    fa, ua = fused.state(), unfused.state()
    u_dx = max(float((ua.x - fa.x).abs().max()),
               float((ua.y - fa.y).abs().max()))
    vscale = float(torch.maximum(fa.vx.abs().max(), fa.vy.abs().max()))
    u_dv = max(float((ua.vx - fa.vx).abs().max()),
               float((ua.vy - fa.vy).abs().max()))
    u_rb = unfused.rebin_count - 1
    print(f"# phase 17: unfused D=2 (K1 + K8) vs fused over {UNFUSED_STEPS} "
          f"steps at 1M: rebins {u_rb} / {fused.rebin_count - 1}, |dx| "
          f"{u_dx:.3e} (<= 1e-4), |dv| {u_dv:.3e} of max|v| {vscale:.3f} "
          f"(<= 1e-3 rel, phase 10's bars); overflow {unfused.overflow}; "
          f"launches {launches}", flush=True)
    check(launches["forces_slab"] == launches["density"] == 2 * UNFUSED_STEPS
          and launches["forces_integrate"] == 0
          and launches["reslot"] == 2 * u_rb,
          f"unfused sharded launches {launches}")
    check(unfused.overflow == 0 and u_dx <= 1e-4 and u_dv <= 1e-3 * vscale,
          "unfused sharded vs fused")
    row = next(k for k in kernels if k["name"] == "forces_slab")
    row["launches"] = launches["forces_slab"]
    row["launches_path"] = (f"unfused D=2 ShardedSession, {UNFUSED_STEPS} "
                            f"steps")
    del fused, unfused, fa, ua
    # the halo's cost: the copying and the in-place posture, ref-based
    timing = {}
    for label, kw in (("copying", {}), ("in place", dict(donate=True))):
        sess = session(**kw)
        sess.run(WARM_STEPS)
        timing[label] = busy_ms(sess, HALO_STEPS)
        del sess
    print(f"# phase 17: D=2 at 1M, {WARM_STEPS} + {HALO_STEPS} steps + "
          f"{BREAKDOWN_STEPS} profiled: " + "; ".join(
              f"{k} halo {v[0]:.4f} ms/step (CUDA events), device busy "
              f"{v[1]:.4f} ms/step" for k, v in timing.items())
          + f" on {card} (no gain is claimed)", flush=True)
    # a refless save -> restore -> RESTORE_STEPS, bitwise
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "refless")
        b.save(path)
        b.run(RESTORE_STEPS)
        back = ShardedSession.restore(path, mesh, refless_trigger=True)
        back.run(RESTORE_STEPS)
        same = slab_sims_equal(b.sim, back.sim)
        try:
            ShardedSession.restore(path, mesh, refless_trigger=False)
            refused = False
        except ValueError:
            refused = True
        print(f"# phase 17: refless ShardedSession.save -> restore -> "
              f"{RESTORE_STEPS} steps bitwise an uninterrupted run: {same}; "
              f"a ref-based restore refused: {refused}", flush=True)
        check(same and refused, "sharded refless checkpoint")
    del b, back, runs


def ceiling_spec(side: int, D: int):
    """The scale scene's ShardSpec (side x side particles, D slabs)."""
    from bevy_gpu_fluid_tpu_torch.parallel import shard
    extent = side * 0.04
    return shard.ShardSpec.build(
        h=0.045 * 1.75, x_min=-1.0, x_max=extent + 1.0,
        y_max=extent * 1.1 + 1.0, n_devices=D, capacity=side * side)


def peaks_apart(sess) -> tuple:
    """A ShardedSession's step peak and rebin peak apart: pure steps to
    the trigger, then the rebin alone.  Returns (pure steps, step peak,
    rebin peak, rebin ms), peaks as ``max_memory_allocated``."""
    steps_fn = sess._steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    to_need = 0
    while not steps_fn.need(sess.sim):
        sess.sim = steps_fn.pure_step(sess.sim)
        to_need += 1
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    r0 = sess.rebin_count
    start.record()
    sess.sim = steps_fn.rebin(sess.sim)
    end.record()
    end.synchronize()
    check(sess.rebin_count == r0 + 1, "peaks_apart: no rebin")
    return (to_need, step_peak, torch.cuda.max_memory_allocated(),
            start.elapsed_time(end))


def sharded_footprints(card: str) -> None:
    """Phase 17 (c), first: the copying (``donate=False``) and owned
    postures' peaks of a D = 2 ``ShardedSession`` on the one card, on a
    16M scale scene, in slab-plane-footprints per slab (bytes above what
    was allocated before, over D slab planes): pure steps to the trigger,
    then one rebin.  Each budgeted posture must stay within what its
    automatic choice budgets: ``verlet_solver.FOOTPRINTS`` plus, copying,
    ``shard_verlet.HALO_COPY_FOOTPRINTS``."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.parallel import shard_verlet as sv
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession

    dev = torch.device("cuda", 0)
    D = 2
    side = math.isqrt(PROBE_N)
    n = side * side
    spec = ceiling_spec(side, D)
    slab_b = plane_bytes(spec.local_grid)
    params, cfg, _ = scale_scene(side)
    print(f"# phase 17: copying vs owned postures, D={D} on cuda:0, {n:,} "
          f"particles, slab planes {spec.local_grid.plane_shape} "
          f"({slab_b / 2**20:.1f} MiB); peaks in slab-plane-footprints per "
          f"slab, recovery armed, on {card}", flush=True)
    for name, (knobs, key) in SHARDED_PROBE.items():
        gc_collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        sess = ShardedSession.from_generator(
            bt.lattice_gen(side, 0.04, dev), n, params, cfg, spec,
            SlabMesh([dev] * D), segmented=False, **knobs)
        sess.run(2)     # the references now differ from the positions
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        to_need, step_peak, rebin_peak, _ = peaks_apart(sess)
        fp = lambda b: (b - base) / (D * slab_b)
        peak = max(fp(step_peak), fp(rebin_peak))
        budget = None if key is None else (
            vs.FOOTPRINTS[key]
            + (0.0 if knobs["donate"] else sv.HALO_COPY_FOOTPRINTS))
        print(f"#   {name:24s} resident {resident / (D * slab_b):.3f}, "
              f"{to_need} pure steps {fp(step_peak):.3f}, rebin "
              f"{fp(rebin_peak):.3f}; budgeted "
              f"{'-' if budget is None else f'{budget:.3f}'}", flush=True)
        check(sess.overflow == 0 and sess.lost == 0,
              f"{name}: overflow or loss")
        check(budget is None or peak <= budget,
              f"{name}: peak {peak:.3f} slab planes over its budget {budget}")
        del sess


def sharded_ceiling(kernels: list, card: str) -> None:
    """Phase 17 (c): the sharded memory ceiling on the one card:
    ``ShardedSession.from_generator`` at D = 2 (each slab gets half of the
    card) at an N the sharded default posture does not fit, its postures
    left automatic."""
    from types import SimpleNamespace

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
    from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import \
        ShardedSession

    dev = torch.device("cuda", 0)
    D = 2
    total = torch.cuda.mem_get_info(dev)[1]
    share = total // D
    reserve = vs.RESERVE_BYTES
    spec_of = lambda side: ceiling_spec(side, D)

    def slab_capacity(footprints):
        lo, hi = 64, 1 << 17
        while hi - lo > 1:
            mid = (lo + hi) // 2
            fits = (footprints * plane_bytes(spec_of(mid).local_grid)
                    + reserve <= share)
            lo, hi = (mid, hi) if fits else (lo, mid)
        return lo * lo

    n_default = slab_capacity(vs.FOOTPRINTS["default"])
    n_planar = slab_capacity(vs.FOOTPRINTS["planar"])
    n_ceiling = slab_capacity(vs.FOOTPRINTS["ceiling"])
    side = math.isqrt((n_planar + int(0.95 * n_ceiling)) // 2)
    n = side * side
    check(n_planar < n <= 0.95 * n_ceiling,
          f"no N between the ref-based planar capacity {n_planar} and 0.95 "
          f"x the ceiling's {n_ceiling}")
    spec = spec_of(side)
    g = spec.local_grid
    slab_b = plane_bytes(g)
    params, cfg, _ = scale_scene(side)
    print(f"# phase 17: sharded ceiling, D={D} on cuda:0 (each slab gets "
          f"{share / 2**30:.2f} GiB of {total / 2**30:.2f}): {n:,} particles "
          f"({side} x {side}); slab planes {g.plane_shape} "
          f"({g.row_block}-row blocks) = {slab_b / 2**30:.3f} GiB each, "
          f"{D * slab_b / 2**30:.3f} GiB a plane of both; per-slab "
          f"capacities (footprints x slab plane + {reserve / 2**30:.0f} GiB "
          f"in a slab's share): default posture {n_default:,}, ref-based "
          f"planar {n_planar:,}, ceiling {n_ceiling:,}; on {card}",
          flush=True)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = ShardedSession.from_generator(bt.lattice_gen(side, 0.04, dev), n,
                                         params, cfg, spec,
                                         SlabMesh([dev] * D))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fp = lambda b: b / (D * slab_b)
    init_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    posture = dict(refless_trigger=sess.refless_trigger,
                   planar_rebin=sess.planar_rebin, segmented=sess.segmented,
                   donate=sess.donate)
    print(f"#   posture chosen {posture}; from_generator init {t_init:.2f} s, "
          f"peak {init_peak / 2**30:.2f} GiB = {fp(init_peak):.3f} "
          f"slab-plane-footprints per slab (resident {fp(resident):.3f}); "
          f"alive {sess.alive}, overflow {sess.overflow} on {card}",
          flush=True)
    check(sess.refless_trigger and sess.planar_rebin and sess.donate,
          f"the defaults did not choose the ceiling posture: {posture}")
    check(sum(sess.alive) == n, f"init alive {sess.alive} of {n}")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    r0 = sess.rebin_count
    steps = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with SmiSampler() as run_smi:
        start.record()
        while steps < SHARDED_CEILING_MIN or (
                sess.rebin_count == r0 and steps < SHARDED_CEILING_MAX):
            sess.run(25)
            steps += 25
        end.record()
        end.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rebins = sess.rebin_count - r0
    ms_step = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated()
    sane = [planes_sane(SimpleNamespace(**{
        k: getattr(sess.sim, k)[d][:, :, 1:g.nx + 1]
        for k in ("xd", "yd", "vxd", "vyd")}), cfg) for d in range(D)]
    live = sum(v["live"] for v in sane)
    print(f"#   {steps} steps: {ms_step:.3f} ms/step (CUDA events; host "
          f"{wall / steps * 1e3:.3f}) = {n / ms_step * 1e3 / 1e9:.3f}G "
          f"particle-steps/s; rebins {rebins}, overflow {sess.overflow}, "
          f"lost {sess.lost}, dropped {sess.dropped}, suspended "
          f"{sess.suspended}; real columns per slab {sane}; peak "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB = "
          f"{fp(peak):.3f} slab-plane-footprints per slab (the single "
          f"card's ceiling posture: 10.000 planes); launches {launches}; "
          f"{run_smi.summary()} on {card}", flush=True)
    check(all(v["finite_in_box"] and v["dead_far"] for v in sane)
          and live == n - sess.suspended, f"sharded ceiling fields {sane}")
    check(sess.overflow == 0 and sess.lost == 0 and sess.dropped == 0,
          "sharded ceiling overflow or loss")
    check(rebins >= 1, "no rebin in the sharded ceiling run")
    check(launches["forces_integrate_refless_lanes"] == D * steps
          and launches["density_out_slab"] == D * steps
          and launches["density"] == D * steps,
          f"refless K2 with lanes / K1 out= launches {launches}")
    check(launches["select_clip"] == D * rebins
          and launches["apply_code"] == 5 * D * rebins
          and launches["reslot"] == launches["mono_step"] == 0,
          f"K6/K7 launches {launches} for {rebins} rebins")
    check(peak < total, f"peak {peak} over the card's {total}")
    for k in kernels:
        if k["name"] in ("forces_integrate_refless_lanes", "density_out_slab"):
            k["launches"] = launches[k["name"]]
            k["launches_path"] = (f"sharded ceiling, D=2, {n} particles, "
                                  f"{steps} steps")
    to_need, step_peak, rebin_peak, rebin_ms = peaks_apart(sess)
    print(f"#   peaks apart: {to_need} pure steps {fp(step_peak):.3f}, one "
          f"rebin {fp(rebin_peak):.3f} slab-plane-footprints per slab "
          f"({rebin_ms:.1f} ms, CUDA events): the rebin peaks "
          f"{'ABOVE' if rebin_peak > step_peak else 'at or below'} the "
          f"step on {card}", flush=True)
    check(sess.overflow == 0 and sess.lost == 0, "ceiling rebin loss")
    del sess


def footprints_and_ceiling(kernels: list, card: str) -> None:
    """Phase 14: the postures' plane-footprints on a 16M scene, then the
    ceiling run with every posture left to its default.  Runs last."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import cuda_solver
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.ops import reslot

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"# phase 14: device memory free {free / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f} GiB ({total} B; torch holds "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB) on {card}",
          flush=True)

    side = math.isqrt(PROBE_N)
    n = side * side
    params, cfg, grid = scale_scene(side)
    plane = plane_bytes(grid)
    fp = {}
    for name, knobs in PROBE_POSTURES.items():
        kw = dict(knobs)
        if kw.pop("stencils", False):
            kw["stencils"] = cuda_solver.make_stencils(grid)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sess = vs.Session.from_generator(bt.lattice_gen(side, 0.04, dev), n,
                                         params, cfg, grid, device=dev, **kw)
        torch.cuda.synchronize()
        f = dict(init=torch.cuda.max_memory_allocated() - base)
        sess.run(2)     # the references now differ from the positions
        torch.cuda.synchronize()
        f["resident"] = torch.cuda.memory_allocated() - base
        check(not sess._need(sess.sim), f"{name}: trigger at step 2")
        torch.cuda.reset_peak_memory_stats()
        sess.run(1)
        torch.cuda.synchronize()
        f["step"] = torch.cuda.max_memory_allocated() - base
        while not sess._need(sess.sim):
            sess.sim = sess._pure_step(sess.sim)
        r0 = sess.sim.rebin_count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sess.run(1)
        torch.cuda.synchronize()
        f["rebin"] = torch.cuda.max_memory_allocated() - base
        check(sess.sim.rebin_count == r0 + 1, f"{name}: no rebin")
        if name == "ceiling":
            # the planar rebin's recovery collect, which runs only when a
            # particle lost its slot: select, the drops read off the code,
            # the spill gather, on top of the resident planes
            s = sess.sim
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            code, _ = reslot.select_cuda(s.xd, s.yd, grid, s.occ)
            dropped = (s.idx_d >= 0) & ~reslot.taken_mask(code, grid.cap)
            vs._spill_collect(dropped, (s.xd, s.yd, s.vxd, s.vyd, s.idx_d),
                              (s.sx, s.sy, s.svx, s.svy, s.sidx))
            torch.cuda.synchronize()
            f["collect"] = torch.cuda.max_memory_allocated() - base
            del s, code, dropped
        if name == "ceiling_tail":
            # the same tail with the plain integrate (new planes for all
            # four outputs, a plane of temporaries per operation)
            s = sess.sim
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rho = cuda_solver.density_cuda(s.xd, s.yd, params, grid, s.occ,
                                           out=s.rho_d)
            ax, ay = cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd, rho,
                                             params, grid, s.occ)
            res = cuda_solver.integrate(s.xd, s.yd, s.vxd, s.vyd, ax, ay,
                                        s.xd, s.yd, cfg)
            torch.cuda.synchronize()
            f["plain_integrate_step"] = (torch.cuda.max_memory_allocated()
                                         - base)
            del s, rho, ax, ay, res
        fp[name] = {k: v / plane for k, v in f.items()}
        fp[name]["peak"] = max(fp[name]["step"], fp[name]["rebin"])
        del sess
    reserve = vs.RESERVE_BYTES
    cap = {k: capacity(v["peak"], total, reserve) for k, v in fp.items()}
    print(f"#   plane-footprints (peak allocated bytes / one plane of "
          f"{plane / 2**20:.1f} MiB) of a {n}-particle scale scene "
          f"{grid.plane_shape}, recovery armed, and the particles each "
          f"posture fills this card with ({total} B less "
          f"{reserve / 2**30:.1f} GiB) on {card}:", flush=True)
    for k, v in fp.items():
        print(f"#   {k:18s} " + ", ".join(f"{a} {b:.3f}"
                                          for a, b in v.items())
              + f"; fills at N = {cap[k]:,}", flush=True)
    print("#   footprints " + json.dumps({k: round(v["peak"], 3)
                                           for k, v in fp.items()}),
          flush=True)

    # the ceiling run: an N that neither the default posture nor the
    # ref-based planar one fits, at least 5% below the capacity of the
    # posture the defaults choose, below 2^31 slots per plane
    n_default, n_auto = cap["default"], cap["ceiling"]
    n_run = (max(n_default, cap["planar"]) + int(0.95 * n_auto)) // 2
    side = math.isqrt(n_run)
    while plane_bytes(scale_scene(side)[2]) // 4 >= 2 ** 31:
        side -= 16
    n = side * side
    check(n_default < n <= 0.95 * n_auto,
          f"no N between the default posture's capacity {n_default} and "
          f"0.95 x the ceiling posture's {n_auto}: {n}")
    params, cfg, grid = scale_scene(side)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = vs.Session.from_generator(bt.lattice_gen(side, 0.04, dev), n,
                                     params, cfg, grid, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    posture = dict(refless_trigger=sess.refless_trigger,
                   planar_rebin=sess.planar_rebin, segmented=sess.segmented,
                   donate=sess.donate)
    print(f"# phase 14: ceiling run, {n:,} particles ({side} x {side}), "
          f"grid {grid.plane_shape} ({grid.row_block}-row blocks, "
          f"{plane_bytes(grid) // 4:,} slots = "
          f"{plane_bytes(grid) // 4 / 2**31:.3f} x 2^31 per plane, "
          f"{plane_bytes(grid) / 2**30:.2f} GiB); default posture fills at "
          f"{n_default:,}, the ceiling posture at {n_auto:,}; posture "
          f"chosen {posture}; from_generator init {t_init:.2f} s, peak "
          f"{init_peak / 2**30:.2f} GiB", flush=True)
    check(sess.refless_trigger and sess.planar_rebin,
          f"the defaults did not choose the ceiling posture: {posture}")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    r0 = sess.sim.rebin_count
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with SmiSampler() as run_smi:
        start.record()
        sess.run(CEILING_STEPS)
        end.record()
        end.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rebins = sess.sim.rebin_count - r0
    ms_step = start.elapsed_time(end) / CEILING_STEPS
    peak = torch.cuda.max_memory_allocated()
    sane = planes_sane(sess.sim, cfg)
    print(f"#   {CEILING_STEPS} steps: {ms_step:.3f} ms/step (CUDA events; "
          f"host {wall / CEILING_STEPS * 1e3:.3f}) = "
          f"{n / ms_step * 1e3 / 1e9:.3f}G particle-steps/s; rebins "
          f"{rebins}, overflow {sess.sim.overflow}, lost {sess.sim.lost}, "
          f"suspended {sess.suspended}; {sane}; peak "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB "
          f"({peak / plane_bytes(grid):.3f} planes); launches {launches}; "
          f"{run_smi.summary()} on {card}", flush=True)
    check(sane["finite_in_box"] and sane["dead_far"]
          and sane["live"] == n - sess.suspended, f"ceiling fields {sane}")
    check(sess.sim.overflow == 0 and sess.sim.lost == 0,
          "ceiling run overflow or loss")
    check(rebins >= 1, "no rebin in the ceiling run")
    check(launches["select"] == rebins
          and launches["apply_code"] == 5 * rebins,
          f"K6/K7 launches {launches} for {rebins} rebins")
    check(launches["reslot"] == 0 and launches["mono_step"] == 0,
          f"K3/K5 launched on the ceiling path: {launches}")
    check(launches["forces_integrate_refless"] == CEILING_STEPS
          and launches["forces_integrate"] == CEILING_STEPS
          and launches["density"] == CEILING_STEPS,
          f"refless K2 / K1 launches {launches}")
    check(peak < total, f"peak {peak} over the card's {total}")
    row = next(k for k in kernels if k["name"] == "forces_integrate_refless")
    row["launches"] = launches["forces_integrate_refless"]

    # where a ceiling step goes: K1, K2 refless and one rebin by CUDA
    # events against the timed ms/step; torch.profiler's view beside them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.run(CEILING_PROFILED)
        torch.cuda.synchronize()
    # per recorded launch (the trace may drop records), with the count
    by_kernel = sorted(
        ((e.device_time_total / 1e3 / e.count, e.count,
          e.key.replace("(anonymous namespace)::", "").replace("void ", "")
          .split("(")[0][-40:])
         for e in prof.key_averages()
         if getattr(e, "device_type", None) == DeviceType.CUDA
         and e.device_time_total > 0), reverse=True)
    # K1 and K2 refless by CUDA events on the run's planes, ten calls each
    s = sess.sim
    k1_ms = cuda_ms(lambda: cuda_solver.density_cuda(
        s.xd, s.yd, params, grid, s.occ, out=s.rho_d), 10)
    k2_ms = cuda_ms(lambda: cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, s.rho_d, None, None, params, cfg, grid,
        s.occ, refless=True), 10)
    del s
    busy = k1_ms + k2_ms
    start.record()
    sess.sim = sess._rebin(sess.sim)
    end.record()
    end.synchronize()
    rebin_ms = start.elapsed_time(end)
    # the planar rebin's recovery collect on the ceiling planes (no drop
    # made it fire in the run): select, the drops off the code, the spill
    # gather, beside the resident planes
    s = sess.sim
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    code, _ = reslot.select_cuda(s.xd, s.yd, grid, s.occ)
    dropped = (s.idx_d >= 0) & ~reslot.taken_mask(code, grid.cap)
    vs._spill_collect(dropped, (s.xd, s.yd, s.vxd, s.vyd, s.idx_d),
                      (s.sx, s.sy, s.svx, s.svy, s.sidx))
    torch.cuda.synchronize()
    collect_planes = torch.cuda.max_memory_allocated() / plane_bytes(grid)
    del s, code, dropped
    per_rebin = rebin_ms * rebins / CEILING_STEPS
    print(f"#   where a ceiling step goes: K1 {k1_ms:.3f} ms + K2 refless "
          f"{k2_ms:.3f} ms (CUDA events, 10 calls each) + a planar rebin "
          f"(K6, taken counts, 5 x K7, block_kmax3) of {rebin_ms:.2f} ms "
          f"(CUDA events) x {rebins} in {CEILING_STEPS} steps = "
          f"{per_rebin:.3f} ms/step, of {ms_step:.3f} ms/step: the rest, "
          f"{ms_step - busy - per_rebin:.3f} ms/step, is the host, the "
          f"per-step disp2 read and small kernels; torch.profiler over "
          f"{CEILING_PROFILED} steps, per recorded launch: " + "; ".join(
              f"{name} {ms:.3f} ms x{c}" for ms, c, name in by_kernel[:6])
          + f"; the recovery collect on these planes peaks at "
          f"{collect_planes:.3f} planes on {card}", flush=True)
    check(collect_planes < total / plane_bytes(grid),
          f"the recovery collect would not fit: {collect_planes} planes")

    # K2 refless timed and bounded on the ceiling planes
    s = sess.sim
    need_taps, _ = tile_taps(s.xd, s.occ, grid)
    n_live = float(sane["live"])
    args = (s.xd, s.yd, s.vxd, s.vyd, s.rho_d, None, None, params, cfg,
            grid, s.occ)
    k2c = lambda: cuda_solver.forces_integrate_cuda(*args, refless=True)
    c_ms = kernel_ms(k2c, "forces_integrate_kernel<true>", 3)
    with SmiSampler() as k2_smi:     # K2 alone for ~3 s, as in the run
        c_ms_long = cuda_ms(k2c, 100)
    c_bound = bound(9 * 4.0 * s.xd.numel() + 4.0 * s.occ.numel() + 4,
                    need_taps * FORCE_OPS + n_live * 20)
    row.update(ceiling_ms=c_ms, ceiling_ms_100_calls=c_ms_long,
               ceiling_bound_ms=c_bound["bound_ms"],
               ceiling_bound_by=c_bound["bound_by"],
               ceiling_shape=list(grid.plane_shape), ceiling_n=n,
               ceiling_ms_per_step=ms_step)
    print(f"#   K2 refless on the ceiling planes: {c_ms:.3f} ms "
          f"(profiler, 3 calls), {c_ms_long:.3f} ms per call over 100 calls "
          f"(CUDA events; {k2_smi.summary()}), bound "
          f"{c_bound['bound_ms']:.3f} ms by "
          f"{c_bound['bound_by']} ({c_bound['bound_bytes'] / 1e9:.2f} GB, "
          f"{c_bound['bound_ops'] / 1e9:.1f} GFLOP); launches on the "
          f"ceiling path {row['launches']} in {CEILING_STEPS} steps on "
          f"{card}", flush=True)
    del s, args, sess

def png_rgb(data: bytes):
    """The uint8 [H, W, 3] array of a PNG as ``render/png.py`` writes it
    (8-bit RGB, filter 0), decoded here with zlib, every chunk's CRC
    checked."""
    import binascii
    import struct
    import zlib

    import numpy as np
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        check(binascii.crc32(kind + body) & 0xFFFFFFFF == crc,
              f"PNG CRC of {kind}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check((depth, ctype) == (8, 2), f"PNG depth/type {depth}, {ctype}")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG filter bytes")
    return rows[:, 1:].reshape(h, w, 3)


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serve_1m(kernels: list, card: str) -> None:
    """Phase 18 (a): the interactive server on a 1M Session, over HTTP, in
    stages (the loop alone, GETs, impulses), each stage's frames/s read
    from the loop's own counts."""
    import threading
    import urllib.request

    from bevy_gpu_fluid_tpu_torch.examples import interactive
    from bevy_gpu_fluid_tpu_torch.render.png import encode_png

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    app = interactive.InteractiveApp(n=SERVER_N, substeps=FRAME_SUBSTEPS,
                                     session=True, device=dev)
    sess = app.sim.session
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(sess.grid.n_row_blocks >= 12 and not sess.planar_rebin
          and not sess.refless_trigger, "the server's Session posture")
    spec = app.sim.spec
    steps0, rebins0 = sess.sim.step, sess.sim.rebin_count
    stages = []

    def mark(name: str) -> None:
        stages.append((name, time.perf_counter(), app.frames, sess.sim.step,
                       sess.sim.rebin_count, sess.overflow))

    zero_launches()
    t_start = time.perf_counter()
    app.start()
    srv = interactive.make_server(app, 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post(path, body):
        req = urllib.request.Request(url + path, method="POST",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            check(r.status == 200, f"POST {path}: {r.status}")

    def wait_frames(k: int) -> None:
        target = app.frames + k
        deadline = time.perf_counter() + 30
        while app.frames < target:
            check(time.perf_counter() < deadline, "the frame loop stalled")
            time.sleep(0.001)

    pngs, lat, enc = [], [], []
    try:
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            check(b"pointermove" in r.read(), "GET / page")
        mark("start")
        # the loop alone and under back-to-back GETs in short turns, so
        # both sample the same stretch of the dam break (it rebins more
        # often as it goes)
        for _ in range(SERVER_GETS // SERVER_GETS_A_TURN):
            time.sleep(SERVER_ALONE_S)
            mark("alone")
            for _ in range(SERVER_GETS_A_TURN):  # decoded after the loop
                t = time.perf_counter()
                with urllib.request.urlopen(url + "/frame.png",
                                            timeout=30) as r:
                    pngs.append(r.read())
                lat.append(time.perf_counter() - t)
                enc.append(app.encode_s)
            mark("GETs")
        for i in range(SERVER_IMPULSES):      # the self-drive path
            post("/impulse", {"px": spec.width * (0.3 + 0.3 * i /
                                                  SERVER_IMPULSES),
                              "py": spec.height * 0.8, "dx": 6.0, "dy": 0.0})
            wait_frames(1)
        mode = app.mode
        post("/toggle", {})
        check(app.mode != mode, "POST /toggle")
        wait_frames(2)                        # the last kicked frame lands
        mark(f"{SERVER_IMPULSES} x POST /impulse, one frame apart, and a "
             f"toggle")
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        app.stop()
        torch.cuda.synchronize()
        mark("stopped")
        kinds = {}
        for a, b in zip(stages, stages[1:]):
            k = kinds.setdefault(b[0], [0.0, 0, 0, 0, a[3], b[3], 0])
            k[0] += b[1] - a[1]
            k[1] += b[2] - a[2]
            k[2] += b[3] - a[3]
            k[3] += b[4] - a[4]
            k[5], k[6] = b[3], b[5]
        for name, (dt, fr, st, rb, s0, s1, ov) in kinds.items():
            print(f"#   {name}: {dt:.3f} s, {fr} frames = {fr / dt:.1f} "
                  f"frames/s over steps {s0}-{s1} ({st} of them, a rebin "
                  f"per {st / max(rb, 1):.2f} steps), overflow {ov} by its "
                  f"end", flush=True)
    wall = time.perf_counter() - t_start
    th.join(timeout=30)
    check(not th.is_alive(), "the HTTP server thread did not stop")
    launches = read_launches()
    steps = sess.sim.step - steps0
    rebins = sess.sim.rebin_count - rebins0
    frames = steps // FRAME_SUBSTEPS
    frame = app.latest_frame()
    for data in pngs:
        img = png_rgb(data)
        check(img.shape == frame.shape and img.any(),
              f"a served frame: {img.shape} vs {frame.shape}, or black")
    kicks = list(app.kicks)
    shown = [k for k in kicks if k["vmax_after"] > k["vmax_before"]]
    kick_ms = [k["latency_s"] * 1e3 for k in shown] or [float("nan")]
    direct = []
    for _ in range(5):
        t = time.perf_counter()
        encode_png(frame)
        direct.append((time.perf_counter() - t) * 1e3)
    enc_ms = [e * 1e3 for e in enc]
    sane = planes_sane(sess.sim, sess.cfg)
    print(f"# phase 18: server: InteractiveApp(n={SERVER_N:,}, substeps="
          f"{FRAME_SUBSTEPS}, session) init {init_s:.2f} s; frame "
          f"{frame.shape[1]}x{frame.shape[0]}; {frames} frames ({steps} "
          f"steps, {rebins} rebins) in {wall:.2f} s = "
          f"{frames / wall:.1f} frames/s served; GET /frame.png "
          f"x{SERVER_GETS}: p50 {pct(lat, 0.5) * 1e3:.2f} ms, p99 "
          f"{pct(lat, 0.99) * 1e3:.2f} ms, max {max(lat) * 1e3:.2f} ms, "
          f"{len(pngs[-1])} B; PNG encode in the server p50 "
          f"{pct(enc_ms, 0.5):.2f} ms, alone {pct(direct, 0.5):.2f} ms "
          f"(median of 5); impulse POST -> first frame showing it (max |vx|"
          f" grown, {len(shown)} of {len(kicks)} kicked frames): p50 "
          f"{pct(kick_ms, 0.5):.2f} ms, max {max(kick_ms):.2f} ms; stats "
          f"{stats}; launches {launches}; {sane}, suspended "
          f"{sess.suspended}, overflow {sess.sim.overflow} (recoverable "
          f"drops), lost {sess.sim.lost} on {card}", flush=True)
    # This scene overflows its cap-8 cells on its own some 1,300-2,300
    # steps in, the front against the walls (measured on an H100, with no
    # client in that stage); recovery parks the drops and re-admits them.
    # So the gate is the guarantee: no particle lost, every one resident
    # or parked, the fields finite and in the box.
    check(stats["step"] > steps0 and stats["overflow"] <= sess.overflow,
          f"GET /stats {stats}")
    check(sess.sim.lost == 0 and sane["finite_in_box"] and sane["dead_far"]
          and sane["live"] + sess.suspended == SERVER_N,
          f"server fields {sane}, lost {sess.sim.lost}, suspended "
          f"{sess.suspended}")
    check(steps % FRAME_SUBSTEPS == 0 and rebins >= 1,
          f"{steps} steps, {rebins} rebins")
    check(launches["density"] == steps
          and launches["forces_integrate"] == steps
          and launches["reslot"] == rebins
          and launches["field_raster"] == frames
          and launches["mono_step"] == 0, f"server launches {launches} for "
          f"{steps} steps, {rebins} rebins, {frames} frames")
    check(len(kicks) >= 1 and shown, f"no kicked frame showed its impulse "
          f"({kicks[:3]})")
    row = next((k for k in kernels if k["name"] == "field_raster"), None)
    if row is not None:
        row.update(served_launches=launches["field_raster"],
                   served_frames=frames)


def examples_on_card(card: str) -> None:
    """Phase 18 (b): the demo, the sharded demo, entry() and the dry run
    on the card."""
    import tempfile

    from bevy_gpu_fluid_tpu_torch import entry
    from bevy_gpu_fluid_tpu_torch.examples import demo, sharded_demo

    with tempfile.TemporaryDirectory() as out:
        zero_launches()
        r = demo.run(demo.parse_args(["--n", str(DEMO_N), "--frames",
                                      str(DEMO_FRAMES), "--out", out]))
        launches = read_launches()
        files = sorted(f for f in os.listdir(out) if f.endswith(".ppm"))
        check(r["written"] + r["dropped"] == DEMO_FRAMES
              and len(files) == r["written"] >= 1,
              f"demo sink: {r}, {len(files)} files")
        with open(os.path.join(out, files[-1]), "rb") as f:
            check(any(f.read()[20:]), "the demo's last frame is black")
        check(launches["mono_step"] == DEMO_FRAMES * r["substeps"],
              f"demo launches {launches}")
        print(f"# phase 18: demo (verlet, {r['n']:,} particles, "
              f"{DEMO_FRAMES} frames x {r['substeps']} steps, native sink): "
              f"{r['fps']:.1f} frames/s (first frame included), written "
              f"{r['written']}, dropped {r['dropped']}; K5 launches "
              f"{launches['mono_step']} on {card}", flush=True)
    with tempfile.TemporaryDirectory() as out:
        zero_launches()
        r = sharded_demo.run(sharded_demo.parse_args(
            ["--devices", "2", "--frames", str(SHARDED_DEMO_FRAMES),
             "--out", out]))
        launches = read_launches()
        check(r["restore_bitwise"] and r["identity_exact"]
              and sum(r["alive"]) == r["n"], f"sharded demo {r}")
        print(f"# phase 18: sharded_demo D=2 on cuda:0: {r['frames']} "
              f"frames {r['shape']}, alive {r['alive']}, rebins "
              f"{r['rebins']}, restore bitwise, identity exact; launches "
              f"{launches}", flush=True)
    zero_launches()
    fn, args = entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    check(out.x.is_cuda and bool(out.x.isfinite().all()) and out.step == 1
          and launches["mono_step"] == 1, f"entry(): {launches}")
    zero_launches()
    line = entry.dryrun_multichip(DRYRUN_SLABS)
    launches = read_launches()
    check(launches["forces_integrate_lanes"] > 0
          and launches["reslot_clip"] > 0, f"dry run launches {launches}")
    print(f"# phase 18: entry(): one K5 step on {out.x.device}; {line}; "
          f"launches {launches}", flush=True)


AOT_CHILD = r"""
import dataclasses, json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import numpy as np, torch
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.utils import aot
t_import = time.perf_counter() - t0
sess = vs.Session.restore({ckpt!r}, device="cuda")
torch.cuda.synchronize()
t_restore = time.perf_counter() - t0
one = aot.load_exported({art1!r}, out_like=sess.sim)
t_load = time.perf_counter() - t0
first = one(sess.sim)
torch.cuda.synchronize()
t_first = time.perf_counter() - t0
run = aot.load_exported({art!r}, out_like=sess.sim)
out = run(sess.sim)
torch.cuda.synchronize()
t_run = time.perf_counter() - t0
np.savez({out_npz!r}, **{{f.name: np.asarray(
    getattr(out, f.name).cpu() if torch.is_tensor(getattr(out, f.name))
    else getattr(out, f.name)) for f in dataclasses.fields(out)}})
print(json.dumps(dict(import_s=t_import, restore_s=t_restore,
                      load_s=t_load, first_step_s=t_first, run_s=t_run,
                      first_step=first.step, step=out.step)))
"""


def aot_1m(sess, card: str) -> None:
    """Phase 18 (c): the 1M Session's artifact in a fresh process, bitwise
    the live Session; the operators' host cost per step."""
    import shutil
    import tempfile

    import numpy as np

    from bevy_gpu_fluid_tpu_torch.kernels import ops
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.utils import aot

    tmp = tempfile.mkdtemp()
    try:
        ckpt = os.path.join(tmp, "snap.npz")
        art = os.path.join(tmp, f"run{AOT_STEPS}.bgfexp")
        art1 = os.path.join(tmp, "run1.bgfexp")
        out_npz = os.path.join(tmp, "out.npz")
        sess.save(ckpt)
        t = time.perf_counter()
        aot.export_session_run(sess, AOT_STEPS, art)
        export_s = time.perf_counter() - t
        aot.export_session_run(sess, 1, art1)
        code = AOT_CHILD.format(root=ROOT, ckpt=ckpt, art=art, art1=art1,
                                out_npz=out_npz)
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=ROOT)
        child_s = time.perf_counter() - t
        check(r.returncode == 0, f"aot child failed:\n{r.stderr[-3000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        r0 = sess.sim.rebin_count
        sess.run(AOT_STEPS)
        torch.cuda.synchronize()
        with np.load(out_npz) as z:
            diff = []
            for f in dataclasses.fields(sess.sim):
                want = getattr(sess.sim, f.name)
                want = (want.cpu().numpy() if torch.is_tensor(want)
                        else np.asarray(want))
                if (z[f.name].dtype != want.dtype
                        or not np.array_equal(z[f.name], want)):
                    diff.append(f.name)
        check(not diff, f"aot run differs from the live Session in {diff}")
        check(child["step"] == sess.sim.step and child["first_step"]
              == sess.sim.step - AOT_STEPS + 1, f"aot steps {child}")
        print(f"# phase 18: aot: the 1M Session's {AOT_STEPS}-step artifact "
              f"({os.path.getsize(art)} B, exported in {export_s:.2f} s) "
              f"in a fresh process from a checkpoint: bitwise the live "
              f"Session over {AOT_STEPS} steps ({sess.sim.rebin_count - r0} "
              f"rebins; every field, integers and floats): True; the child "
              f"(kernel library cached): imports {child['import_s']:.2f} s, "
              f"restored {child['restore_s']:.2f} s, artifact loaded "
              f"{child['load_s']:.2f} s, FIRST STEP FINISHED "
              f"{child['first_step_s']:.2f} s after its start, "
              f"{AOT_STEPS} steps done {child['run_s']:.2f} s; the child's "
              f"wall {child_s:.2f} s on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the operators' dispatch: host time per pure step, same snapshot
    pure_op, _, _ = vs.make_step_parts(sess.params, sess.cfg, sess.grid,
                                       n=sess.n, kernels=ops)
    snap = sess.sim

    def host_us(pure) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DISPATCH_STEPS):
            pure(snap)
        us = (time.perf_counter() - t) / DISPATCH_STEPS * 1e6
        torch.cuda.synchronize()
        return us

    host_us(sess._pure_step)
    host_us(pure_op)
    turns = [("direct", sess._pure_step), ("operators", pure_op),
             ("operators", pure_op), ("direct", sess._pure_step)]
    got = {}
    for name, pure in turns:
        got.setdefault(name, []).append(host_us(pure))
    direct = sum(got["direct"]) / 2
    opus = sum(got["operators"]) / 2
    print(f"# phase 18: custom-operator dispatch: a 1M pure step (K1 + K2) "
          f"enqueues in {direct:.1f} us through the direct launchers and "
          f"{opus:.1f} us through torch.ops.bgf (turns direct, operators, "
          f"operators, direct: {got}): +{opus - direct:.1f} us per step "
          f"({DISPATCH_STEPS} steps a turn, host clock, no sync inside) on "
          f"{card}", flush=True)


def timer_and_trace(sess, card: str) -> None:
    """Phase 18 (d): StepTimer against CUDA events; a trace of 8 steps."""
    import tempfile

    from bevy_gpu_fluid_tpu_torch.utils import profiling

    timer = profiling.StepTimer(sess.n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    done = []
    with timer.measure(TIMER_STEPS, result=done):
        start.record()
        sess.run(TIMER_STEPS)
        end.record()
        done.append(sess.sim.xd)
    ev_ms = start.elapsed_time(end) / TIMER_STEPS
    tm_ms = timer.seconds / timer.steps * 1e3
    check(timer.steps == TIMER_STEPS and abs(tm_ms - ev_ms) <= 0.15 * ev_ms,
          f"StepTimer {tm_ms} vs events {ev_ms} ms/step")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as prof:
            sess.run(TRACE_STEPS)
        text = open(os.path.join(d, "trace.json")).read()
        size = len(text)
    check("density_kernel" in text and "forces_integrate_kernel" in text,
          "the trace does not name K1 and K2")
    k = {e.key: e.count for e in prof.key_averages()
         if "density_kernel" in e.key or "forces_integrate_kernel" in e.key}
    print(f"# phase 18: StepTimer over {TIMER_STEPS} 1M steps: "
          f"{tm_ms:.4f} ms/step ({timer.summary()}) vs CUDA events "
          f"{ev_ms:.4f} ms/step ({(tm_ms / ev_ms - 1) * 100:+.2f}%); "
          f"trace() of {TRACE_STEPS} steps: {size} B of Chrome trace naming "
          f"{k} on {card}", flush=True)


def serving_and_tooling(kernels: list, card: str) -> None:
    """Phase 18: the serving and tooling entry points on the card.  The
    aot and timer parts take phase 4's regime (a fresh 1M Session after
    300 steps), not the server's Session, which ends deep in the dam break
    (a rebin every step or two)."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs

    t0 = time.perf_counter()
    serve_1m(kernels, card)
    gc_collect()
    examples_on_card(card)
    extent = N_SIDE * 0.04
    sess = vs.Session(bt.init_grid(N_SIDE, N_SIDE, 0.04, "cuda"),
                      bt.FluidParams.demo(),
                      bt.IntegrateConfig.create(x_min=-1.0,
                                                x_max=extent + 1.0),
                      vs.default_grid(0.045, -1.0, extent + 1.0,
                                      y_max=extent * 1.1 + 1.0),
                      device="cuda")
    sess.run(WARM_STEPS)
    aot_1m(sess, card)
    timer_and_trace(sess, card)
    print(f"# phase 18: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)



def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the GPU")
    if sys.argv[1:] == ["17"]:      # phase 17 alone: no result line
        kernels, card = [], smi_line()
        sharded_postures_1m(kernels, card)
        gc_collect()
        sharded_footprints(card)
        gc_collect()
        sharded_ceiling(kernels, card)
        print(json.dumps({"kernels": kernels}))
        return
    if sys.argv[1:] == ["18"]:      # phase 18 alone: no result line
        from bevy_gpu_fluid_tpu_torch.kernels import _build
        _build.load()
        serving_and_tooling([], smi_line())
        return
    kernels, card = paths_1m()
    gc_collect()
    ceiling_mechanisms_1m(kernels, card)
    gc_collect()
    slab_mesh(kernels, card)
    gc_collect()
    sharded_postures_1m(kernels, card)
    gc_collect()
    sharded_footprints(card)
    gc_collect()
    sharded_ceiling(kernels, card)
    gc_collect()
    serving_and_tooling(kernels, card)
    gc_collect()
    footprints_and_ceiling(kernels, card)    # last: it needs the card
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
