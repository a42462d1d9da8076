"""Simulation facade (port of ``bevy_gpu_fluid_tpu/core/simulation.py``):
params + config + grid + solver behind a small stateful API.

    sim = Simulation.dam_break()                 # 5,041-particle scene
    sim.run(100)                                 # 100 steps on the GPU
    sim.kick(1.0, 0.3, dir_x=0.6, dir_y=0.45)    # mouse-drag impulse
    frame = sim.frame()                          # uint8 RGB [H, W, 3]

Solvers: ``"verlet"`` (the default) holds a RESIDENT
``verlet_solver.Session``: the dense slot state stays on the device across
``run``/``run_frame``/``run_frames``/``kick``, and the per-particle
``state`` materializes lazily.  ``"golden"`` steps the all-pairs reference
model (models/reference.py).  ``"pallas"`` and ``"xla"`` (the eager grid
solvers, which need kernel K8), ``validate``/``validate_every`` (the
validator) and ``save``/``load`` (checkpoints) are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.

Frame modes: ``"density"``/``"const"`` are per-particle splats at the
``raster_width``-wide ``spec``; ``"field"``/``"field_const"`` are the
grid-aligned density-field raster (kernel K4), which the verlet solver
renders straight from its dense planes.
"""

from __future__ import annotations

import math

import torch

from ..interact.impulse import apply_impulse
from ..models import reference as golden
from ..models import verlet_solver
from ..ops.binning import FAR, bin_particles, to_dense
from ..render import raster
from .params import FluidParams, GridSpec2D, IntegrateConfig
from .state import FluidState, init_grid

_NOT_PORTED = {
    "pallas": "the eager pallas solver needs kernel K8 (ROADMAP B2)",
    "xla": "the eager XLA grid solver is not ported (ROADMAP B2)",
    "validate": "utils/validator.py is not ported (ROADMAP B3)",
    "save": "checkpoints are not ported (ROADMAP B4)",
}


class Simulation:
    """Stateful convenience wrapper over the solvers."""

    def __init__(self, state: FluidState, params: FluidParams,
                 cfg: IntegrateConfig, grid: GridSpec2D,
                 solver: str = "verlet", raster_width: int = 512,
                 y_view_max: float | None = None, validate_every: int = 0,
                 device="cuda"):
        if solver in ("pallas", "xla"):
            raise NotImplementedError(f"solver={solver!r}: "
                                      f"{_NOT_PORTED[solver]}")
        if solver not in ("verlet", "golden"):
            raise ValueError(f"unknown solver {solver!r}")
        if validate_every > 0:
            raise NotImplementedError(f"validate_every: "
                                      f"{_NOT_PORTED['validate']}")
        self.params = params
        self.cfg = cfg
        self.grid = grid
        self.solver = solver
        self.device = torch.device(device)
        self._dense_cache = None   # (state object, (xd, yd)), golden field
        self.spec = raster.RasterSpec.fit(
            float(cfg.x_min), float(cfg.x_max), float(cfg.floor_y),
            y_view_max if y_view_max is not None
            else float(cfg.floor_y) + grid.ny * grid.cell_size,
            width=raster_width)
        self._state = state.to(self.device)
        self._session = None
        self._dirty = False
        if solver == "verlet":
            self._session = verlet_solver.Session(self._state, params, cfg,
                                                  grid, device=self.device)
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
        """Cumulative capacity-overflow count (0 in all standard scenes; the
        golden solver has no cells to overflow)."""
        return 0 if self._session is None else self._session.overflow

    # ---- scene builders ---------------------------------------------------
    @staticmethod
    def _grid(solver: str, x_min: float, x_max: float, y_max: float,
              cap: int) -> GridSpec2D:
        """The verlet solver's skin grid, or a plain grid of cell h for the
        others (the reference's grid_solver.default_grid)."""
        if solver == "verlet":
            return verlet_solver.default_grid(0.045, x_min, x_max,
                                              y_max=y_max, cap=cap)
        return GridSpec2D.from_bounds(h=0.045, x_min=x_min, x_max=x_max,
                                      y_min=0.0, y_max=y_max, cap=cap)

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
    def run(self, n_steps: int) -> None:
        """Advance n_steps.  Returns nothing: read ``state`` when the
        per-particle fields are wanted (on the verlet engine that extracts
        them from the dense planes)."""
        if self._session is not None:
            self._session.run(n_steps)
            self._dirty = True
            return
        self._state = golden.multi_step(self._state, self.params, self.cfg,
                                        n_steps)

    def validate(self, raise_on_fail: bool = True, mode: str = "full"):
        raise NotImplementedError(f"validate: {_NOT_PORTED['validate']}")

    def save(self, path: str) -> None:
        raise NotImplementedError(f"save: {_NOT_PORTED['save']}")

    def load(self, path: str) -> None:
        raise NotImplementedError(f"load: {_NOT_PORTED['save']}")

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
        (golden) from a binning cached per state object."""
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
        """Advance ``substeps`` steps and rasterize."""
        self.run(substeps)
        return self.frame(mode)

    def run_frames(self, n_frames: int, substeps: int = 16,
                   mode: str = "density") -> torch.Tensor:
        """``n_frames`` frames (the same trajectory as that many
        ``run_frame`` calls), stacked as uint8 [n_frames, H, W, 3]."""
        return torch.stack([self.run_frame(substeps, mode)
                            for _ in range(n_frames)])
