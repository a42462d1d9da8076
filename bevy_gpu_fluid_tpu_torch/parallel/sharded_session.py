"""The persistent sharded run: the ``Session`` facade over the slabs of a
``SlabMesh`` (port of ``bevy_gpu_fluid_tpu/parallel/sharded_session.py``).

One x-slab per mesh device (``parallel/shard_verlet.py``), frames from
per-slab raster strips (``parallel/shard_render.py``), original-order
extraction through the tracked particle index, resident checkpoints that
continue bitwise, and the in-engine validator over the whole domain.  The
step loop is ``verlet_solver.Session``'s (``verlet_solver.run_steps``, a
``bgf.step`` span a step): each step reads the slabs' ``disp2`` back in
one sync.  Moving from one card to a
mesh is a constructor swap.  The very-large-N postures (the unfused step,
the chunked and generator inits, owned planes, the refless trigger, the
segmented driver) are the single card's, per slab.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams, IntegrateConfig
from ..core.state import FluidState
from ..interact.impulse import IMPULSE, apply_impulse_arrays
from ..models.verlet_solver import (planar_rebin_default,
                                    refless_trigger_default, run_steps,
                                    segmented_run_default)
from ..ops.binning import FAR
from . import shard as sh
from . import shard_render, shard_verlet
from .mesh import SlabMesh


def _sharded_fingerprint(fused: bool, stencils, recover: bool,
                         refless: bool, max_age: int) -> dict:
    """Solver knobs a checkpoint records and a restore must match, in the
    reference's kinds (its ``_sharded_fingerprint``): the fused kernels
    ("fused-pallas"), an explicit stencil pair ("custom-stencils") or the
    plain one ("xla-stencils"), recovery, and the refless trigger and the
    bins' age limit (both change the rebin schedule; the reference's
    session has no age knob, and its artifacts lack the key).  The planar
    rebin, the inits, donation and the segmented driver are bit-neutral
    and absent."""
    return {"solver": "fused-pallas" if fused else
            ("custom-stencils" if stencils is not None else "xla-stencils"),
            "recovery": recover, "refless": refless, "max_age": max_age}


class ShardedSession:
    """Persistent run over ``spec.n_devices`` slabs.

    ``run(k)`` advances k steps (collective rebins, ghost-column halos and
    the any-reduced trigger included); ``run_frame``/``run_frames``/
    ``frame`` assemble a seamless uint8 frame from per-slab raster strips;
    ``state()`` materializes the ORIGINAL-order FluidState on demand;
    ``save``/``restore`` round-trip the resident state bitwise; ``kick``
    applies the drag impulse on every slab; ``validate`` runs the
    in-engine validator on the whole domain.

    ``mesh`` defaults to ``SlabMesh(n=spec.n_devices)``, all slabs on the
    current CUDA card; pass ``SlabMesh(["cpu"] * D)`` for the CPU.
    ``recover=False`` counts drops without collecting or re-admitting them.
    ``max_age`` is the bins' age at which a rebin comes whatever the
    trigger reads (``Session``'s knob; a checkpoint and an exported run
    record it).
    ``fused=False`` steps on ``stencils`` (None: the plain
    ``grid_solver.XLA_STENCILS``; ``cuda_solver.make_stencils(g)`` for
    K1 + K8) with the integrate as torch ops.

    The very-large-N knobs, the sharded twins of ``Session``'s:
    ``planar_rebin`` rebins with K6 + 5 x K7 instead of K3, bit for bit
    the same; ``init_chunks=K`` builds each slab from K chunks of its
    buffer (bitwise the sort-based init); ``donate=True`` makes the session
    OWN its planes (the halo in place, K1 into the dead rho, the planar
    rebin consuming its inputs), so a ``ShardedDenseSim`` taken from
    ``self.sim`` is invalidated by the next step (snapshot with ``save`` or
    ``state()``); ``refless_trigger`` drops the reference planes for a
    conservative summed-displacement trigger (not bitwise the ref-based
    one); ``segmented`` runs ``step_until`` segments and each rebin apart
    (bitwise the standard run).  ``planar_rebin``, ``refless_trigger`` and
    ``segmented`` left None are chosen from the memory each slab gets of
    its card (``shard_verlet.slab_default`` over the single card's
    ``planar_rebin_default``, ``refless_trigger_default`` and
    ``segmented_run_default``), less the copying halo's planes unless
    ``donate``; all are off on the CPU.  ``from_generator`` builds the
    scene chunk by chunk on each slab.
    """

    def __init__(self, state: FluidState | None, params: FluidParams,
                 cfg: IntegrateConfig, spec: sh.ShardSpec,
                 mesh: SlabMesh | None = None, *, fused: bool = True,
                 stencils=None, recover: bool = True,
                 spill_cap: int = shard_verlet.SPILL_CAP,
                 planar_rebin: bool | None = None,
                 init_chunks: int | None = None, donate: bool = False,
                 segmented: bool | None = None,
                 refless_trigger: bool | None = None, max_age: int = 64,
                 _sim=None, _n: int | None = None, _gen=None):
        self.mesh = SlabMesh(n=spec.n_devices) if mesh is None else mesh
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.n = state.n if state is not None else int(_n)
        g = spec.local_grid
        auto = lambda choose: shard_verlet.slab_default(choose, g, self.mesh,
                                                        donate)
        if planar_rebin is None:
            planar_rebin = auto(planar_rebin_default)
        if refless_trigger is None:
            refless_trigger = auto(refless_trigger_default)
        if segmented is None:
            segmented = auto(segmented_run_default)
        self.planar_rebin = planar_rebin
        self.refless_trigger = refless_trigger
        self.segmented = segmented
        self.donate = donate
        self._steps = shard_verlet.make_sharded_verlet_step(
            params, cfg, spec, self.mesh, max_age=max_age,
            n=self.n if recover else None,
            spill_cap=spill_cap, planar=planar_rebin, stencils=stencils,
            fused=fused, init_chunks=init_chunks, refless=refless_trigger,
            gen=_gen, gen_n=self.n if _gen is not None else None,
            donate=donate)
        self._fingerprint = _sharded_fingerprint(fused, stencils, recover,
                                                 refless_trigger, max_age)
        self._frames: dict = {}
        if state is not None:
            self.sim = self._steps.init(sh.shard_state(state, spec,
                                                       self.mesh))
        elif _gen is not None:
            self.sim = self._steps.init(0)
        else:
            self.sim = _sim

    @classmethod
    def from_generator(cls, gen, n: int, params: FluidParams,
                       cfg: IntegrateConfig, spec: sh.ShardSpec,
                       mesh: SlabMesh | None = None, *,
                       init_chunks: int = 16, donate: bool = True,
                       **kw) -> "ShardedSession":
        """A session whose initial scene ``gen`` COMPUTES chunk by chunk on
        each slab (``gen(gi)`` maps global particle indices to (x, y, vx,
        vy) tensors, e.g. ``core.state.lattice_gen``): neither the [N]
        FluidState nor the slabs' [capacity] buffers ever exist.  Bitwise
        ``ShardedSession(state, init_chunks=K)`` for the same scene.  The
        defaults are the very-large-N posture (``init_chunks=16``,
        ``donate=True``); ``kw`` as the constructor's."""
        return cls(None, params, cfg, spec, mesh, init_chunks=init_chunks,
                   donate=donate, _gen=gen, _n=n, **kw)

    # ---- stepping -------------------------------------------------------

    def run(self, n_steps: int, chunk: int | None = None) -> None:
        """Advance n_steps (``verlet_solver.run_steps``): per step, a
        collective rebin if the trigger fired, then the slabs' kernels."""
        run_steps(self, n_steps, chunk, self._steps.pure_step,
                  self._steps.need, self._steps.rebin, self.segmented)

    def _frame_fn(self, px_per_cell: int, mode: str):
        key = (px_per_cell, mode)
        if key not in self._frames:
            self._frames[key] = shard_render.make_sharded_frame(
                self.params, self.spec, self.mesh, px_per_cell, mode)
        return self._frames[key]

    def frame(self, px_per_cell: int = 2,
              mode: str = "density") -> torch.Tensor:
        """uint8 [H, W, 3] field frame of the resident state (row 0 = top),
        W spanning every slab; no stepping."""
        return self._frame_fn(px_per_cell, mode)(self.sim)

    def run_frame(self, substeps: int = 16, px_per_cell: int = 2,
                  mode: str = "density") -> torch.Tensor:
        """``substeps`` steps, then the frame."""
        self.run(substeps)
        return self.frame(px_per_cell, mode)

    def run_frames(self, n_frames: int, substeps: int = 16,
                   px_per_cell: int = 2,
                   mode: str = "density") -> torch.Tensor:
        """``n_frames`` x (``substeps`` steps + frame), stacked as uint8
        [n_frames, H, W, 3]: the same as sequential ``run_frame`` calls."""
        return torch.stack([self.run_frame(substeps, px_per_cell, mode)
                            for _ in range(n_frames)])

    def kick(self, x: float, y: float, dir_x: float, dir_y: float,
             impulse: float = IMPULSE) -> None:
        """Drag impulse on every slab's resident planes (float32
        arithmetic); the ghost columns' copies get it too and are refreshed
        from their owners at the next step's halo."""
        f = np.float32
        sim = self.sim
        vx, vy = [], []
        for xd, yd, vxd, vyd in zip(sim.xd, sim.yd, sim.vxd, sim.vyd):
            a, b = apply_impulse_arrays(xd, yd, vxd, vyd, f(x), f(y),
                                        f(dir_x), f(dir_y), f(impulse))
            live = xd < FAR * 0.5
            vx.append(torch.where(live, a, 0.0))
            vy.append(torch.where(live, b, 0.0))
        self.sim = dataclasses.replace(sim, vxd=vx, vyd=vy)

    # ---- extraction / persistence --------------------------------------

    def state(self) -> FluidState:
        """ORIGINAL-order per-particle FluidState on slab 0's device."""
        return shard_verlet.extract_fluid_state(self.sim, self.spec,
                                                self.params, self.n)

    def save(self, path: str) -> None:
        """Snapshot the resident slabs (counters included) with the spec,
        the physics and the solver knobs' fingerprint, in the reference's
        npz layout (``utils/checkpoint.save_sharded``)."""
        from ..utils import checkpoint
        checkpoint.save_sharded(path, self.sim, self.spec, self.params,
                                self.cfg, self.n,
                                fingerprint=self._fingerprint)

    @classmethod
    def restore(cls, path: str, mesh: SlabMesh | None = None, *,
                fused: bool = True, stencils=None, recover: bool = True,
                planar_rebin: bool | None = None,
                refless_trigger: bool | None = None, donate: bool = False,
                segmented: bool | None = None,
                max_age: int = 64) -> "ShardedSession":
        """A session from ``save`` (or the reference's ``save_sharded``),
        slab d on ``mesh.devices[d]`` (the card by default); it continues
        bitwise.  The solver knobs are supplied again and must match the
        artifact's fingerprint (``fused``, ``stencils``' kind, ``recover``,
        the trigger, ``max_age``), or ValueError.  ``refless_trigger=None``
        resolves through ``shard_verlet.slab_default`` BEFORE the check, as
        the reference does."""
        from ..utils import checkpoint
        if mesh is None:
            with np.load(checkpoint._norm(path)) as z:
                mesh = SlabMesh(n=int(z["spec.n_devices"]))
        sim, spec, params, cfg, n = checkpoint.load_sharded(path, mesh)
        if refless_trigger is None:
            refless_trigger = shard_verlet.slab_default(
                refless_trigger_default, spec.local_grid, mesh, donate)
        checkpoint.check_fingerprint(
            checkpoint.load_fingerprint(path),
            _sharded_fingerprint(fused, stencils, recover, refless_trigger,
                                 max_age),
            "ShardedSession.restore")
        return cls(None, params, cfg, spec, mesh, fused=fused,
                   stencils=stencils, recover=recover,
                   spill_cap=sim.sx[0].shape[0], planar_rebin=planar_rebin,
                   donate=donate, segmented=segmented,
                   refless_trigger=refless_trigger, max_age=max_age,
                   _sim=sim, _n=n)

    def export_run(self, n_steps: int, path: str) -> None:
        """Artifact of ``run(n_steps)`` (``utils/aot.export_sharded_run``):
        the slab pure step as a graph, the trigger and the collective
        rebin rebuilt by the loader from the recorded parameters."""
        from ..utils import aot
        aot.export_sharded_run(self, n_steps, path)

    def validate(self, rel_tol: float | None = None,
                 acc_abs_tol: float | None = None,
                 raise_on_fail: bool = True):
        """The in-engine validator on the whole domain: the particles in
        original order (those lost beyond the spill, at FAR, left out),
        re-evaluated through a binning and the plain stencils on the grid
        every slab together covers, against the O(N^2) golden model
        (``utils/validator.validate_accelerated``)."""
        from ..utils import validator
        fs = self.state()
        live = fs.x < FAR * 0.5
        fs = FluidState(**{k: getattr(fs, k)[live] for k in
                           ("x", "y", "vx", "vy", "ax", "ay", "rho", "p")},
                        step=fs.step)
        kw = {}
        if rel_tol is not None:
            kw["rel_tol"] = rel_tol
        if acc_abs_tol is not None:
            kw["acc_abs_tol"] = acc_abs_tol
        return validator.validate_accelerated(
            fs, self.params, self.spec.global_grid(),
            raise_on_fail=raise_on_fail, **kw)

    # ---- diagnostics ----------------------------------------------------

    @property
    def alive(self) -> list[int]:
        """Live particles per slab."""
        return list(self.sim.alive)

    @property
    def overflow(self) -> int:
        return sum(self.sim.overflow)

    @property
    def dropped(self) -> int:
        return sum(self.sim.dropped)

    @property
    def lost(self) -> int:
        return sum(self.sim.lost)

    @property
    def suspended(self) -> int:
        return self.sim.suspended

    @property
    def readmitted(self) -> int:
        return sum(self.sim.readmitted)

    @property
    def rebin_count(self) -> int:
        return self.sim.rebin_count

    @property
    def step(self) -> int:
        return self.sim.step
