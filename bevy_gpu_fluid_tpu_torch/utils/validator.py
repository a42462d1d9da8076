"""In-engine runtime validator: accelerated state vs the golden model (port
of ``bevy_gpu_fluid_tpu/utils/validator.py``).

Three entry points, at the reference's tolerances:

* ``validate(state, params)``: rho, p and the accelerations of a state that
  carries them (e.g. after ``grid_solver.compute_rho_p_acc``) against the
  all-pairs golden model, at the in-engine tolerances (1% relative, or 0.5
  absolute on the accelerations);
* ``validate_fields(state, params)``: the stored rho and p only (rho <= 1%
  relative, p <= 30 absolute); works on any solver's state;
* ``validate_accelerated(state, params, grid, stencils)``: re-evaluates rho,
  p and the accelerations through the accelerated stencils at the state's
  positions (one more binning + density + forces) and runs ``validate`` on
  the result; what ``Simulation(validate_every=K)`` runs for the grid
  solvers.

On failure they raise ``ParityError`` with the three worst particles and the
filtered relative pressure error over |p| > 30.  The golden model is O(N^2):
these are spot checks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import FluidParams
from ..core.state import FluidState
from ..models import grid_solver
from ..models import reference as golden

# the reference's in-engine tolerances
REL_TOL = 0.01
ACC_ABS_TOL = 0.5
# the reference's parity-harness tolerances
P_ABS_TOL = 30.0
P_FILTER = 30.0  # |p| threshold for the filtered relative metric


class ParityError(AssertionError):
    pass


@dataclasses.dataclass
class ParityReport:
    rho_max_rel: float
    p_max_rel: float
    acc_max_rel: float
    acc_max_abs: float
    p_max_abs: float = 0.0
    p_rel_filtered: float = 0.0  # max rel err over |p_truth| > P_FILTER

    def __str__(self):
        return (f"parity: rho {self.rho_max_rel:.2e} rel, "
                f"p {self.p_max_rel:.2e} rel / {self.p_max_abs:.2e} abs "
                f"(filtered rel>|{P_FILTER:.0f}| {self.p_rel_filtered:.2e}), "
                f"acc {self.acc_max_rel:.2e} rel / "
                f"{self.acc_max_abs:.2e} abs")


def _max_rel(a, b, eps) -> float:
    return float(((a - b).abs() / torch.clamp_min(b.abs(), eps)).max())


def top_offenders(name: str, err, state: FluidState, k: int = 3) -> str:
    """The k worst particles by ``err`` with their positions and
    velocities."""
    err = np.asarray(torch.as_tensor(err).cpu())
    idx = np.argsort(err)[::-1][:k]
    x, y, vx, vy = (np.asarray(t.cpu()) for t in
                    (state.x, state.y, state.vx, state.vy))
    lines = [f"top {len(idx)} {name} offenders:"]
    for rank, i in enumerate(idx):
        lines.append(
            f"  #{rank + 1} particle {int(i)}: err={err[i]:.3e} "
            f"pos=({x[i]:.4f}, {y[i]:.4f}) vel=({vx[i]:.4f}, {vy[i]:.4f})")
    return "\n".join(lines)


def _p_metrics(p_acc, p_truth):
    """p max-abs, and the relative error only where the golden pressure
    exceeds P_FILTER (small pressures would amplify noise)."""
    abs_err = (p_acc - p_truth).abs()
    rel = torch.where(p_truth.abs() > P_FILTER,
                      abs_err / torch.clamp_min(p_truth.abs(), 1e-12), 0.0)
    return float(abs_err.max()), float(rel.max())


def _rho_error(state: FluidState, truth: FluidState) -> str:
    rho_err = (state.rho - truth.rho).abs() / torch.clamp_min(
        truth.rho.abs(), 1e-6)
    return top_offenders("rho-rel", rho_err, state)


def validate(state: FluidState, params: FluidParams,
             rel_tol: float = REL_TOL, acc_abs_tol: float = ACC_ABS_TOL,
             raise_on_fail: bool = True) -> ParityReport:
    """Check state.rho/p/ax/ay against the golden model at the state's
    positions and velocities."""
    truth = golden.accel_field(golden.density_pressure(state, params), params)
    p_abs, p_filt = _p_metrics(state.p, truth.p)
    report = ParityReport(
        rho_max_rel=_max_rel(state.rho, truth.rho, 1e-6),
        p_max_rel=_max_rel(state.p, truth.p, 1.0),
        acc_max_rel=max(_max_rel(state.ax, truth.ax, 1.0),
                        _max_rel(state.ay, truth.ay, 1.0)),
        acc_max_abs=max(float((state.ax - truth.ax).abs().max()),
                        float((state.ay - truth.ay).abs().max())),
        p_max_abs=p_abs, p_rel_filtered=p_filt)
    ok = (report.rho_max_rel <= rel_tol and report.p_max_rel <= rel_tol
          and (report.acc_max_rel <= rel_tol
               or report.acc_max_abs <= acc_abs_tol))
    if not ok and raise_on_fail:
        raise ParityError(f"{report}\n{_rho_error(state, truth)}")
    return report


def validate_accelerated(state: FluidState, params: FluidParams, grid,
                         stencils=None, rel_tol: float = REL_TOL,
                         acc_abs_tol: float = ACC_ABS_TOL,
                         raise_on_fail: bool = True) -> ParityReport:
    """Recompute rho/p/ax/ay through the accelerated path (binning + the
    given stencils, the XLA stencils by default) at the state's positions
    and velocities, then ``validate`` them: a full check for solvers whose
    states carry no accelerations."""
    acc_state, _ = grid_solver.compute_rho_p_acc(
        state, params, grid, stencils or grid_solver.XLA_STENCILS)
    return validate(acc_state, params, rel_tol, acc_abs_tol, raise_on_fail)


def validate_fields(state: FluidState, params: FluidParams,
                    rho_rel_tol: float = REL_TOL,
                    p_abs_tol: float = P_ABS_TOL,
                    raise_on_fail: bool = True) -> ParityReport:
    """Check the stored density and pressure only (rho <= 1% relative, p
    <= 30 absolute); works for every solver.  The stored rho is taken at
    the last step's pre-integrate positions, one dt behind the positions,
    as in the reference's own check."""
    truth = golden.density_pressure(state, params)
    p_abs, p_filt = _p_metrics(state.p, truth.p)
    report = ParityReport(
        rho_max_rel=_max_rel(state.rho, truth.rho, 1e-6),
        p_max_rel=_max_rel(state.p, truth.p, 1.0),
        acc_max_rel=0.0, acc_max_abs=0.0,
        p_max_abs=p_abs, p_rel_filtered=p_filt)
    ok = report.rho_max_rel <= rho_rel_tol and report.p_max_abs <= p_abs_tol
    if not ok and raise_on_fail:
        raise ParityError(f"{report}\n{_rho_error(state, truth)}")
    return report
