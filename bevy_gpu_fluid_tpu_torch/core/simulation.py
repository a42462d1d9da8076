"""Simulation facade (port of ``bevy_gpu_fluid_tpu/core/simulation.py``):
params + config + grid + solver behind a small stateful API.

    sim = Simulation.dam_break()                 # 5,041-particle scene
    sim.run(100)                                 # 100 steps on the GPU
    sim.kick(1.0, 0.3, dir_x=0.6, dir_y=0.45)    # mouse-drag impulse
    frame = sim.frame()                          # uint8 RGB [H, W, 3]

Solvers: ``"verlet"`` (the default) holds a RESIDENT
``verlet_solver.Session``: the dense slot state stays on the device across
``run``/``run_frame``/``run_frames``/``kick``, and the per-particle
``state`` materializes lazily.  ``"pallas"`` is the eager grid solver on
kernels K1 + K8 (``cuda_solver.multi_step``: a sort-based binning every
step), ``"xla"`` the same glue with the plain-torch stencils
(``grid_solver.multi_step``), and ``"golden"`` the all-pairs reference
model (models/reference.py).  For the eager solvers ``overflow`` is the
largest per-step count seen.

``validate()`` is a golden-model spot check (utils/validator.py):
``mode="full"`` re-evaluates rho, p and the accelerations through this
simulation's own stencils (K1 + K8 for ``"verlet"`` and ``"pallas"``);
``mode="fields"`` checks the stored rho and p.  With ``validate_every=K``,
``run`` runs it once K steps have passed since the last check and keeps the
report in ``last_parity``; ``ParityError`` is raised on a violation.
``save``/``load`` checkpoint the per-particle state with params and cfg
(utils/checkpoint.py, the reference's npz format); ``load`` takes the
artifact's physics when it carries them and rebuilds the solver.

Frame modes: ``"density"``/``"const"`` are per-particle splats at the
``raster_width``-wide ``spec``; ``"field"``/``"field_const"`` are the
grid-aligned density-field raster (kernel K4), which the verlet solver
renders straight from its dense planes.
"""

from __future__ import annotations

import math

import torch

from ..interact.impulse import apply_impulse
from ..models import cuda_solver, grid_solver, verlet_solver
from ..models import reference as golden
from ..ops.binning import FAR, bin_particles, to_dense
from ..render import raster
from ..utils import validator
from .params import FluidParams, GridSpec2D, IntegrateConfig
from .state import FluidState, init_grid

class Simulation:
    """Stateful convenience wrapper over the solvers."""

    def __init__(self, state: FluidState, params: FluidParams,
                 cfg: IntegrateConfig, grid: GridSpec2D,
                 solver: str = "verlet", raster_width: int = 512,
                 y_view_max: float | None = None, validate_every: int = 0,
                 device="cuda"):
        if solver not in ("verlet", "pallas", "xla", "golden"):
            raise ValueError(f"unknown solver {solver!r}")
        self.params = params
        self.cfg = cfg
        self.grid = grid
        self.solver = solver
        self.device = torch.device(device)
        self.validate_every = validate_every
        self.last_parity = None
        self._steps_since_validate = 0
        self._overflow = 0         # eager: largest per-step count; or set
        self._y_view_max = y_view_max
        self._raster_width = raster_width
        self._state = state.to(self.device)
        self._rebuild()

    def _rebuild(self) -> None:
        """(Re)build the raster spec and, for the verlet solver, the
        resident Session from the CURRENT state, params, cfg and grid:
        the constructor's, and ``load``'s when the artifact brings its own
        physics."""
        cfg, grid = self.cfg, self.grid
        self._dense_cache = None   # (state object, (xd, yd)): field frames
        self.spec = raster.RasterSpec.fit(
            float(cfg.x_min), float(cfg.x_max), float(cfg.floor_y),
            self._y_view_max if self._y_view_max is not None
            else float(cfg.floor_y) + grid.ny * grid.cell_size,
            width=self._raster_width)
        self._session = None
        self._dirty = False
        if self.solver == "verlet":
            self._session = verlet_solver.Session(
                self._state, self.params, cfg, grid, device=self.device)
            self._dirty = True   # the dense re-bin reorders the f32 sums

    # ---- state / diagnostics --------------------------------------------
    @property
    def state(self) -> FluidState:
        """The per-particle FluidState.  On the resident verlet engine it
        materializes from the dense slot state on demand and is cached until
        the next step or kick."""
        if self._session is not None and self._dirty:
            self._state = self._session.state()
            self._dirty = False
        return self._state

    @state.setter
    def state(self, value: FluidState) -> None:
        self._state = value.to(self.device)
        self._dirty = False
        if self._session is not None:
            self._session.reset(self._state)   # fresh binning

    @property
    def overflow(self) -> int:
        """Capacity overflow: on the verlet engine the larger of the set
        value and the Session's cumulative count, the largest per-step count
        seen on the eager solvers, 0 on the golden one (it has no cells)."""
        if self._session is not None:
            return max(self._overflow, self._session.overflow)
        return self._overflow

    @overflow.setter
    def overflow(self, v: int) -> None:
        self._overflow = v

    # ---- scene builders ---------------------------------------------------
    @staticmethod
    def _grid(solver: str, x_min: float, x_max: float, y_max: float,
              cap: int) -> GridSpec2D:
        """The verlet solver's skin grid, or a plain grid of cell h for the
        others."""
        if solver == "verlet":
            return verlet_solver.default_grid(0.045, x_min, x_max,
                                              y_max=y_max, cap=cap)
        return grid_solver.default_grid(0.045, x_min, x_max, y_max=y_max,
                                        cap=cap)

    @staticmethod
    def dam_break(n: int = 5041, solver: str = "verlet", cap: int = 8,
                  device="cuda", **kw) -> "Simulation":
        """The reference demo scene: a sqrt(n)-square block in the [-5, 3]
        bounce box."""
        side = int(math.isqrt(n))
        grid = Simulation._grid(solver, -5.0, 3.0, 4.0, cap)
        return Simulation(init_grid(side, side, 0.04, device),
                          FluidParams.demo(), IntegrateConfig.create(), grid,
                          solver=solver, device=device, **kw)

    @staticmethod
    def pool(n: int = 102_400, aspect: float = 16.0, solver: str = "verlet",
             cap: int = 8, bounce: float = -0.5, max_depth_rows: int = 25,
             device="cuda", **kw) -> "Simulation":
        """A wide, shallow pool with a dissipative bounce: the large-N scene
        (depth capped at ``max_depth_rows`` rows, widened to keep n)."""
        rows = max(4, min(int(math.sqrt(n / aspect)), max_depth_rows))
        cols = max(4, n // rows)
        width = cols * 0.04
        height = rows * 0.04
        cfg = IntegrateConfig.create(x_min=-0.5, x_max=width + 0.5,
                                     bounce=bounce)
        y_max = height * 3.0 + 0.5
        grid = Simulation._grid(solver, -0.5, width + 0.5, y_max, cap)
        return Simulation(init_grid(cols, rows, 0.04, device),
                          FluidParams.demo(), cfg, grid, solver=solver,
                          y_view_max=y_max, device=device, **kw)

    # ---- stepping / interaction / rendering --------------------------------
    def _advance(self, n_steps: int) -> None:
        if self._session is not None:
            self._session.run(n_steps)
            self._dirty = True
            return
        if self.solver == "golden":
            self._state = golden.multi_step(self._state, self.params,
                                            self.cfg, n_steps)
            return
        multi = (cuda_solver.multi_step if self.solver == "pallas"
                 else grid_solver.multi_step)
        self._state, diag = multi(self._state, self.params, self.cfg,
                                  self.grid, n_steps)
        self._overflow = max(self._overflow, diag.overflow)

    def run(self, n_steps: int) -> None:
        """Advance n_steps.  Returns nothing: read ``state`` when the
        per-particle fields are wanted (on the verlet engine that extracts
        them from the dense planes).  With ``validate_every=K`` a parity
        check runs once K or more steps have passed since the last one
        (``ParityError`` on a violation; the report in ``last_parity``)."""
        self._advance(n_steps)
        if self.validate_every > 0:
            self._steps_since_validate += n_steps
            if self._steps_since_validate >= self.validate_every:
                self._steps_since_validate = 0
                self.last_parity = self.validate()

    def validate(self, raise_on_fail: bool = True, mode: str = "full"):
        """One golden-model parity spot check.  ``mode="full"``: rho, p and
        the accelerations re-evaluated through this simulation's stencils
        (the plain-torch ones for ``"xla"``, K1 + K8 otherwise) at the
        current positions, at the in-engine tolerances (1% relative, 0.5
        absolute on the accelerations).  ``mode="fields"`` (and the golden
        solver, which has no accelerated path): the stored rho and p."""
        if mode == "fields" or self.solver == "golden":
            return validator.validate_fields(self.state, self.params,
                                             raise_on_fail=raise_on_fail)
        stencils = (grid_solver.XLA_STENCILS if self.solver == "xla"
                    else cuda_solver.make_stencils(self.grid))
        return validator.validate_accelerated(
            self.state, self.params, self.grid, stencils,
            raise_on_fail=raise_on_fail)

    def save(self, path: str) -> None:
        """Write the per-particle state with params and cfg (an npz in the
        reference's format; ``Session.save`` keeps the resident state)."""
        from ..utils import checkpoint
        checkpoint.save(path, self.state, self.params, self.cfg)

    def load(self, path: str) -> None:
        """Restore a checkpoint.  Params and cfg the artifact carries
        REPLACE the simulation's and the solver is rebuilt, so a run saved
        under other physics goes on with that physics; the binning grid,
        static geometry, is kept (a new box wants a new Simulation)."""
        from ..utils import checkpoint
        state, params, cfg = checkpoint.load(path, self.device)
        if params is None and cfg is None:
            self.state = state           # the setter re-seeds the Session
            return
        self.params = params if params is not None else self.params
        self.cfg = cfg if cfg is not None else self.cfg
        self._state = state
        self._rebuild()

    def kick(self, x: float, y: float, dir_x: float, dir_y: float,
             impulse: float | None = None) -> None:
        """Inject a drag impulse around (x, y) along (dir_x, dir_y)."""
        kw = {} if impulse is None else {"impulse": impulse}
        if self._session is not None:
            self._session.kick(x, y, dir_x, dir_y, **kw)
            self._dirty = True
            return
        self._state = apply_impulse(self._state, x, y, dir_x, dir_y, **kw)

    def _splat_frame(self, mode: str) -> torch.Tensor:
        return raster.to_rgb8(raster.render(self.state, self.params,
                                            self.spec, mode))

    def _field_frame(self, mode: str) -> torch.Tensor:
        """Field frame of the current state: from the resident planes, or
        (the other solvers) from a binning cached per state object."""
        fmode = "const" if mode == "field_const" else "density"
        if self._session is not None:
            return self._session.frame(px_per_cell=2, mode=fmode)
        s = self.state
        if self._dense_cache is None or self._dense_cache[0] is not s:
            b = bin_particles(s.x, s.y, self.grid)
            self._dense_cache = (s, (to_dense(b, s.x, FAR),
                                     to_dense(b, s.y, FAR)))
        xd, yd = self._dense_cache[1]
        return raster.field_frame(xd, yd, self.params, self.grid,
                                        px_per_cell=2, mode=fmode)

    def frame(self, mode: str = "density") -> torch.Tensor:
        """Rasterize the current state; returns uint8 [H, W, 3] (row 0 =
        top).  Modes 'density' / 'const' (per-particle splats) and 'field'
        / 'field_const' (the density-field raster, for N >> 100k)."""
        if mode.startswith("field"):
            return self._field_frame(mode)
        return self._splat_frame(mode)

    def run_frame(self, substeps: int = 16,
                  mode: str = "density") -> torch.Tensor:
        """Advance ``substeps`` steps and rasterize (no parity check: that
        is ``run``'s)."""
        self._advance(substeps)
        return self.frame(mode)

    def run_frames(self, n_frames: int, substeps: int = 16,
                   mode: str = "density") -> torch.Tensor:
        """``n_frames`` frames (the same trajectory as that many
        ``run_frame`` calls), stacked as uint8 [n_frames, H, W, 3]."""
        return torch.stack([self.run_frame(substeps, mode)
                            for _ in range(n_frames)])
