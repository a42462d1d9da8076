"""The reference package's chip tools (the repo's ``tools/`` and its root
``bench.py``), ported to the card:
``python -m bevy_gpu_fluid_tpu_torch.tools.<name>``.

``bench`` is ``bench.py``: particle-steps/s on the 1M dam break in its
differential window, printed last as ``bench.py``'s one JSON line (the
same keys, metric name and rounding), and its modes (``--solver pallas``,
``--sweep``, ``--fps``, ``--frames``, ``--golden``); its tests run on the
CPU (``pytest tests/test_torch_bench.py``).  ``validate_longrun`` (the
long-horizon pool and the resident-checkpoint restore), ``dryrun_d8`` (D
= 8 slabs at 102,400 particles), ``bench_mono_ab`` (the mono step K5
against K1 + K2), ``bench_scale`` (one card near its memory ceiling),
``bench_sharded`` (the slab path) and ``bench_aot`` (cold starts with and
without an exported artifact); and the reference's kernel experiments
against their production counterparts, ``exp_forces`` (K8's arithmetic
variants), ``exp_tlayout`` (K1 and K8 on slot-major planes) and
``exp_dbuf`` (K2 staged ahead, persistent).  Each runs on the CUDA card
unless given ``--cpu`` (``device="cpu"`` for its functions, which run the
kernels' PyTorch twins), and raises rather than fall back to the CPU when
no card is found.  Each ``main(argv)`` returns 0 when every gate holds,
else 1 (``bench`` has no gate and returns 0, as ``bench.py`` has none),
and prints the reference tool's lines (its JSON line under its metric
names, where it has one).
"""

from __future__ import annotations

import math
from typing import NamedTuple


def resolve(device):
    """``device`` as a ``torch.device``; RuntimeError for a CUDA device
    when there is no card (a tool never carries on on the CPU)."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False): this tool runs on the card; pass --cpu "
                           "to run it on the CPU")
    return device


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Scene(NamedTuple):
    """The tools' dam break: a square lattice of particles at spacing 0.04
    in a box one unit wider than the lattice on either side."""
    state: object       # FluidState (None: not made)
    params: object      # FluidParams.demo()
    cfg: object         # IntegrateConfig over [-1, extent + 1]
    grid: object        # verlet_solver.default_grid of the box
    extent: float       # the lattice's width (and height)


def dam_break(n: int, device, skin: float = 1.5,
              state: bool = True, cap: int = 8) -> Scene:
    """The dam break of isqrt(n)^2 particles, its grid's cells ``skin`` x h
    (``cap`` slots each) over [-1, extent + 1] x [0, 1.1 extent + 1];
    without ``state`` (a generator init) no particle tensor is made."""
    import bevy_gpu_fluid_tpu_torch as bt
    from ..models import verlet_solver

    side = math.isqrt(n)
    extent = side * 0.04
    return Scene(bt.init_grid(side, side, 0.04, device) if state else None,
                 bt.FluidParams.demo(),
                 bt.IntegrateConfig.create(x_min=-1.0, x_max=extent + 1.0),
                 verlet_solver.default_grid(0.045, -1.0, extent + 1.0,
                                            y_max=extent * 1.1 + 1.0,
                                            cap=cap, skin_factor=skin),
                 extent)


def developed(n: int, device, skin: float = 1.75, steps: int = 300):
    """The kernel experiments' scene: the dam break of ~``n`` particles
    (cells ``skin`` x h) after ``steps`` Session steps, so that the slot
    occupancy is the flow's.  Returns (sim, scene, rho0): the DenseSim, the
    Scene and K1's density of its planes."""
    from ..models import cuda_solver, verlet_solver
    sc = dam_break(n, device, skin)
    sess = verlet_solver.Session(sc.state, sc.params, sc.cfg, sc.grid,
                                 device=device)
    sess.run(steps)
    sim = sess.sim
    rho0 = cuda_solver.density_cuda(sim.xd, sim.yd, sc.params, sc.grid,
                                    sim.occ)
    return sim, sc, rho0


def timed_ms(fn, iters: int, device) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call: CUDA events on the card, the host clock on the
    CPU."""
    import time

    import torch
    fn()
    if torch.device(device).type == "cuda":
        sync(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def slab_spec(n: int, extent: float, skin: float, devices: int,
              capacity: int):
    """The dam break's slab spec: ``devices`` slabs of cells ``skin`` x h,
    ``capacity`` particles a slab."""
    from ..parallel import shard
    return shard.ShardSpec.build(
        h=0.045 * skin, x_min=-1.0, x_max=extent + 1.0,
        y_max=extent * 1.1 + 1.0, n_devices=devices, capacity=capacity)


def identity(idx_d: list, n: int, device) -> tuple[bool, int]:
    """Whether the live ids of the slabs' idx planes are exactly 0..n-1
    (counted on ``device``, one bincount per slab), and how many live ids
    there are."""
    import torch
    cnt = torch.zeros(n, dtype=torch.int64, device=device)
    live = 0
    for idx in idx_d:
        ids = idx[idx >= 0].to(device=device, dtype=torch.int64)
        live += ids.numel()
        if ids.numel() and (int(ids.max()) >= n or int(ids.min()) < 0):
            return False, live
        cnt += torch.bincount(ids, minlength=n)
    return bool((cnt == 1).all()) and live == n, live


def counters() -> dict:
    """Every kernel wrapper's launch counter (it counts CUDA launches
    only), by kernel: (wrapper, counter attribute)."""
    from ..models import cuda_solver, exp_kernels
    from ..ops import reslot
    variants = {f"forces_variant_{v}": (exp_kernels.forces_variant_cuda,
                                        f"launches_{v}")
                for v in exp_kernels.VARIANTS}
    return {"density": (cuda_solver.density_cuda, "launches"),
            "forces_integrate": (cuda_solver.forces_integrate_cuda,
                                 "launches"),
            "mono_step": (cuda_solver.mono_step_cuda, "launches"),
            "forces": (cuda_solver.forces_cuda, "launches"),
            "reslot": (reslot.reslot_cuda, "launches"),
            "select": (reslot.select_cuda, "launches"),
            "apply_code": (reslot.apply_code_cuda, "launches"),
            "forces_integrate_dbuf": (exp_kernels.forces_integrate_dbuf_cuda,
                                      "launches"),
            "density_t": (exp_kernels.density_t_cuda, "launches"),
            "forces_t": (exp_kernels.forces_t_cuda, "launches"),
            **variants}


def launch_counts() -> dict:
    """Every kernel's launches so far (``counters()``)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def launches_since(before: dict) -> dict:
    """The launches of each kernel since ``before`` (``launch_counts()``)."""
    return {k: v - before[k] for k, v in launch_counts().items()}
