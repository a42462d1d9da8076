"""The port's eager solvers, K8 and the validator against the JAX package,
on the CPU.

Inputs are made from a numpy seed and given to both packages (the port gets
them through ``utils/convert.py``).  The JAX side runs as its own tests run
it: Pallas kernels in interpret mode, the XLA stencils and the eager glue
op by op (``jax.disable_jit`` where a ``lax.scan`` would compile the
unrolled stencils for longer than the comparison takes).  The port runs its
kernel wrappers on CPU tensors, i.e. the kernels' PyTorch twins.

Tolerances, and why:
* ``from_dense_multi``, binning and overflow counts: exact (they only move
  values);
* K8 twin vs ``forces_pallas``: 1e-5 of the plane's max |a| per slot — one
  pass of the same pair sum in the same (kj, dx, dy) order; only FP
  contraction and the rsqrt's last bit in XLA:CPU separate the two;
* the XLA stencils: density 1e-5 relative, accelerations 1e-5 of the
  plane's max |a| (the same ops in the same order);
* eager ``multi_step`` over 3 steps: positions 1e-6 absolute, velocities
  1e-4 absolute, rho 1e-5 relative (one step's rounding carried through
  three integrations);
* validator reports: both packages' reports pass (or, for the lagging
  fields, fail) the validator's own tolerances alike, and each metric
  agrees within twice the per-particle gap of the inputs that differ
  between the packages, plus ``REPORT_RTOL`` relative.  Those inputs are
  the two golden all-pairs sums, which torch and XLA:CPU reduce in
  different orders (held to ``NOISE_ULPS`` ulps of the largest |a|, rho
  or k rho), and for ``validate_accelerated`` the two accelerated states.
  A particle's gap is not a few ulps of its own |a|: its sum cancels terms
  far larger than the result.  The metrics of the clean state sit at that
  rounding, so a second test adds known errors and holds every metric
  where they put it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import grid_solver as jgs
from bevy_gpu_fluid_tpu.models import reference as jref
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs
from bevy_gpu_fluid_tpu.ops import binning as jbinning
from bevy_gpu_fluid_tpu.utils import validator as jval

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
from bevy_gpu_fluid_tpu_torch.models import reference as tref
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import binning
from bevy_gpu_fluid_tpu_torch.utils import convert, validator

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5, bounce=-0.5)
VGRID = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)     # verlet, 1.5h
VGRID12 = jvs.default_grid(0.045, -1.0, 2.5, y_max=6.0)   # 12 row blocks
EGRID = jgs.default_grid(0.045, -1.0, 2.5, y_max=3.0)     # eager, h
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
VGRID_T = convert.grid_from(VGRID)
VGRID12_T = convert.grid_from(VGRID12)
EGRID_T = convert.grid_from(EGRID)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def jittered_state(seed=0, side=16, jitter=0.012, vmax=1.5):
    """A side x side lattice at 0.04 spacing, jittered and given random
    velocities from a numpy seed (float32), as a JAX FluidState."""
    rng = np.random.default_rng(seed)
    base = bgf.init_grid(side, side, 0.04)
    n = side * side
    x = (np.asarray(base.x) + rng.uniform(-jitter, jitter, n)) \
        .astype(np.float32)
    y = (np.asarray(base.y) + 0.02 + rng.uniform(-jitter, jitter, n)) \
        .astype(np.float32)
    v = rng.uniform(-vmax, vmax, (2, n)).astype(np.float32)
    return bgf.from_positions(np.stack([x, y], 1)).replace(
        vx=jnp.asarray(v[0]), vy=jnp.asarray(v[1]))


def _to_jax(st):
    """A JAX FluidState holding the port state's values."""
    return bgf.FluidState(**{f: jnp.asarray(getattr(st, f).numpy())
                             for f in ("x", "y", "vx", "vy", "ax", "ay",
                                       "rho", "p")},
                          step=jnp.int32(st.step))


def _amax(*planes):
    return max(float(np.abs(np.asarray(p)).max()) for p in planes)


@pytest.fixture(scope="module")
def dense_pair():
    """The jittered scene's dense sim in both packages (JAX init_dense on
    the verlet grid), with K1's interpret-mode rho."""
    sim_j = jvs.init_dense(jittered_state(side=24), VGRID)
    rho_j = jps.density_pallas(sim_j.xd, sim_j.yd, PARAMS_J, VGRID,
                               interpret=True, occ=sim_j.occ)
    return sim_j, convert.dense_sim_from(_np(sim_j), "cpu"), rho_j


# --------------------------------------------------------------- K8

def test_forces_twin_matches_pallas(dense_pair):
    """K8's twin against ``forces_pallas`` on interior blocks (the TPU
    kernel leaves its ghost blocks unwritten; the port writes 0 there)."""
    sim_j, s, rho_j = dense_pair
    want = jps.forces_pallas(sim_j.xd, sim_j.yd, sim_j.vxd, sim_j.vyd,
                             rho_j, PARAMS_J, VGRID, interpret=True,
                             occ=sim_j.occ)
    got = cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd, _t(rho_j),
                                  PARAMS, VGRID_T, s.occ)
    tb = VGRID.row_block
    wx, wy = (np.asarray(w)[tb:-tb] for w in want)
    scale = _amax(wx, wy)
    assert scale > 100.0          # a compressed, moving scene
    for g, w in zip(got, (wx, wy)):
        np.testing.assert_allclose(g.numpy()[tb:-tb], w, rtol=0,
                                   atol=1e-5 * scale)
        assert (g[:tb] == 0).all() and (g[-tb:] == 0).all()


def test_forces_then_integrate_matches_fused_twin(dense_pair):
    """K8 followed by the torch integrate computes K2's step: the unfused
    and the fused twins agree bitwise on the CPU (one arithmetic)."""
    _, s, rho_j = dense_pair
    rho = _t(rho_j)
    ax, ay = cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd, rho, PARAMS,
                                     VGRID_T, s.occ)
    got = cuda_solver.integrate(s.xd, s.yd, s.vxd, s.vyd, ax, ay, s.ref_xd,
                                s.ref_yd, CFG)
    want = cuda_solver.forces_integrate_cuda(
        s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, CFG,
        VGRID_T, s.occ)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("which", ["forces", "stencils"])
def test_forces_wrapper_checks_and_counts(which, dense_pair):
    """The K8 wrapper raises on a plane it does not take and, on CPU
    tensors, runs the twin without counting a launch; ``make_stencils``
    computes the slot bounds itself when none are given."""
    _, s, _ = dense_pair
    before = (cuda_solver.forces_cuda.launches,
              cuda_solver.density_cuda.launches)
    if which == "forces":
        with pytest.raises(ValueError):
            cuda_solver.forces_cuda(s.xd.double(), s.yd, s.vxd, s.vyd,
                                    s.rho_d, PARAMS, VGRID_T, s.occ)
        with pytest.raises(ValueError):
            cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd, s.rho_d,
                                    PARAMS, VGRID_T, s.occ[:2])
    else:
        density_fn, forces_fn = cuda_solver.make_stencils(VGRID_T)
        rho = density_fn(s.xd, s.yd, PARAMS)
        assert torch.equal(rho, cuda_solver.density_cuda(
            s.xd, s.yd, PARAMS, VGRID_T, s.occ))
        for a, b in zip(forces_fn(s.xd, s.yd, s.vxd, s.vyd, rho, PARAMS),
                        cuda_solver.forces_cuda(s.xd, s.yd, s.vxd, s.vyd,
                                                rho, PARAMS, VGRID_T,
                                                s.occ)):
            assert torch.equal(a, b)
    assert before == (cuda_solver.forces_cuda.launches,
                      cuda_solver.density_cuda.launches)


# --------------------------------------------------------------- glue

def test_from_dense_multi_matches_jax():
    """A crowded scene (overflowed particles get the fallbacks): the
    per-particle reads equal the JAX package's bitwise."""
    sj = jittered_state(seed=1)
    crowd = bgf.init_grid(3, 4, 0.004)
    sj = sj.replace(**{f: jnp.concatenate([getattr(sj, f),
                                           getattr(crowd, f) + 0.32])
                       for f in ("x", "y", "vx", "vy")})
    bj = jbinning.bin_particles(sj.x, sj.y, EGRID, with_csr=False)
    dj = [jbinning.to_dense(bj, sj.vx), jbinning.to_dense(bj, sj.y, 1e9)]
    want = jbinning.from_dense_multi(bj, dj, [7.0, -1.0])
    st = convert.state_from(_np(sj), "cpu")
    b = binning.bin_particles(st.x, st.y, EGRID_T)
    assert b.overflow == int(bj.overflow) >= 4
    got = binning.from_dense_multi(b, [_t(d) for d in dj], [7.0, -1.0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        binning.from_dense(b, _t(dj[0]), 7.0).numpy(), np.asarray(want[0]))


def test_xla_stencils_match_jax():
    """``density_xla`` / ``forces_xla`` (hard r >= EPS gate, centre-slot
    self exclusion) against JAX grid_solver's on the same dense planes."""
    sj = jittered_state(seed=2)
    bj = jbinning.bin_particles(sj.x, sj.y, EGRID, with_csr=False)
    planes = [jbinning.to_dense(bj, sj.x, 1e9),
              jbinning.to_dense(bj, sj.y, 1e9),
              jbinning.to_dense(bj, sj.vx), jbinning.to_dense(bj, sj.vy)]
    rho_j = jgs.density_xla(planes[0], planes[1], PARAMS_J)
    ax_j, ay_j = jgs.forces_xla(*planes, rho_j, PARAMS_J)
    tp = [_t(p) for p in planes]
    rho = grid_solver.density_xla(tp[0], tp[1], PARAMS)
    live = tp[0].numpy() < 5e8
    want = np.asarray(rho_j)
    np.testing.assert_allclose(rho.numpy()[live], want[live], rtol=1e-5)
    ax, ay = grid_solver.forces_xla(*tp, _t(rho_j), PARAMS)
    scale = _amax(ax_j, ay_j)
    assert scale > 10.0
    np.testing.assert_allclose(ax.numpy(), np.asarray(ax_j), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ay.numpy(), np.asarray(ay_j), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("solver", ["pallas", "xla"])
def test_eager_multi_step_matches_jax(solver):
    """Eager steps of the jittered scene, per particle: the port's
    ``cuda_solver.multi_step`` (K1 + K8 twins) against JAX
    ``pallas_solver.multi_step`` (interpret mode), ``grid_solver
    .multi_step`` against JAX's."""
    sj = jittered_state(seed=3, side=12)
    st = convert.state_from(_np(sj), "cpu")
    if solver == "pallas":      # 3 steps
        want, wdiag = jps.multi_step(sj, PARAMS_J, CFG_J, EGRID, 3,
                                     interpret=True)
        got, diag = cuda_solver.multi_step(st, PARAMS, CFG, EGRID_T, 3)
    else:                       # 2 steps (the JAX side runs op by op)
        with jax.disable_jit():
            want, wdiag = jgs.multi_step(sj, PARAMS_J, CFG_J, EGRID, 2)
        got, diag = grid_solver.multi_step(st, PARAMS, CFG, EGRID_T, 2)
    want = _np(want)
    assert diag.overflow == int(wdiag.overflow) == 0
    assert got.step == int(want.step) == (3 if solver == "pallas" else 2)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.y.numpy(), want.y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.vx.numpy(), want.vx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.vy.numpy(), want.vy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=1e-5)
    np.testing.assert_allclose(got.p.numpy(), want.p, rtol=0, atol=1e-2)


def test_eager_overflow_is_counted_and_falls_back():
    """A crowded cell: the step counts the particles left without a slot
    (as JAX does) and gives them the self-density and gravity alone."""
    sj = bgf.init_grid(3, 4, 0.004).replace(
        x=bgf.init_grid(3, 4, 0.004).x + 0.5)
    st = convert.state_from(_np(sj), "cpu")
    out, diag = grid_solver.compute_rho_p_acc(st, PARAMS, EGRID_T,
                                              cuda_solver.make_stencils(
                                                  EGRID_T))
    _, wdiag = jgs.compute_rho_p_acc(sj, PARAMS_J, EGRID)
    assert diag.overflow == int(wdiag.overflow) == 4
    b = binning.bin_particles(st.x, st.y, EGRID_T)
    over = b.rank >= EGRID.cap
    from bevy_gpu_fluid_tpu_torch.ops.kernels import self_density
    assert (out.rho[over] == float(self_density(PARAMS))).all()
    assert (out.ax[over] == 0).all()
    assert (out.ay[over] == np.float32(bt.GRAVITY_Y)).all()


# --------------------------------------------------------------- validator

@pytest.fixture(scope="module")
def validated_state():
    """The jittered scene after 3 eager steps of the port (its fields one
    step behind its positions), as the port's state and a JAX copy."""
    st = convert.state_from(_np(jittered_state(seed=4)), "cpu")
    st, _ = grid_solver.multi_step(st, PARAMS, CFG, EGRID_T, 3)
    return _to_jax(st), st


NOISE_ULPS = 8       # float32 ulps of the largest field a gap may reach
REPORT_RTOL = 1e-5   # relative agreement of two reports beyond their slack


def _gaps(base, other, acc=True):
    """Per report metric, the largest per-particle gap of ``other``'s fields
    from ``base``'s over the denominators the metric divides by (0 for the
    accelerations when ``acc`` is false)."""
    def rel(f, eps):
        b = getattr(base, f)
        return float(((getattr(other, f) - b).abs()
                      / torch.clamp_min(b.abs(), eps)).max())

    def ab(f):
        return float((getattr(other, f) - getattr(base, f)).abs().max())

    return {"rho_max_rel": rel("rho", 1e-6), "p_max_rel": rel("p", 1.0),
            "p_max_abs": ab("p"), "p_rel_filtered": ab("p") / validator.P_FILTER,
            "acc_max_rel": max(rel("ax", 1.0), rel("ay", 1.0)) if acc else 0.0,
            "acc_max_abs": max(ab("ax"), ab("ay")) if acc else 0.0}


def _ulp(*planes):
    return float(np.spacing(np.float32(
        max(float(t.abs().max()) for t in planes))))


def _golden_pair(at):
    """Both packages' golden fields at ``at``'s positions and velocities,
    as port states; asserts that they differ by float32 rounding only:
    ``NOISE_ULPS`` ulps of the largest |a|, of the largest rho over the
    smallest (rho's relative metric), and of the largest rho times the EOS
    stiffness for p (p = k (rho - rho_0))."""
    tt = tref.accel_field(tref.density_pressure(at, PARAMS), PARAMS)
    aj = _to_jax(at)
    tj = convert.state_from(_np(jref.accel_field(
        jref.density_pressure(aj, PARAMS_J), PARAMS_J)), "cpu")
    gap = _gaps(tt, tj)
    assert gap["acc_max_abs"] <= NOISE_ULPS * _ulp(tt.ax, tt.ay), gap
    assert gap["rho_max_rel"] <= (NOISE_ULPS * _ulp(tt.rho)
                                  / float(tt.rho.min())), gap
    assert gap["p_max_abs"] <= (NOISE_ULPS * float(PARAMS.k)
                                * _ulp(tt.rho)), gap
    return tt, tj


def _report_close(got, want, slack):
    """Two reports of one entry point agree within ``slack`` (per metric,
    twice the gap of the inputs that differ between the packages: the
    golden fields and, for ``validate_accelerated``, the accelerated ones;
    twice covers the shift of the denominators) and ``REPORT_RTOL``."""
    for f, s in slack.items():
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 2.0 * s + REPORT_RTOL * max(g, w), (f, g, w, s)


@pytest.mark.parametrize("entry", ["validate", "accelerated", "fields"])
def test_validator_reports_match_jax(entry, validated_state):
    """Each entry point's report on one state in both packages (the same
    accelerated stencils on both sides: the XLA ones).  The stored fields
    lag the positions by a step of a fast scene, so ``validate_fields``
    fails there in both packages: its report is compared unraised.  Here
    every metric sits at float32 rounding, where the two packages' golden
    all-pairs sums (reduced in different orders by torch and XLA:CPU)
    decide it, so the reports are held to the golden models' measured gap;
    ``test_validator_injected_errors_match_jax`` holds them above it."""
    sj, st = validated_state
    at, _ = grid_solver.compute_rho_p_acc(st, PARAMS, EGRID_T)
    tt, tj = _golden_pair(at)
    slack = _gaps(tt, tj, acc=entry != "fields")
    if entry == "validate":
        want = jval.validate(_to_jax(at), PARAMS_J)
        got = validator.validate(at, PARAMS)
    elif entry == "accelerated":
        with jax.disable_jit():
            want = jval.validate_accelerated(sj, PARAMS_J, EGRID)
            at_j, _ = jgs.compute_rho_p_acc(sj, PARAMS_J, EGRID)
        got = validator.validate_accelerated(st, PARAMS, EGRID_T)
        at_j = convert.state_from(_np(at_j), "cpu")
        assert _gaps(at, at_j)["acc_max_abs"] <= NOISE_ULPS * _ulp(at.ax,
                                                                   at.ay)
        slack = {f: s + _gaps(tt, at_j)[f] for f, s in slack.items()}
    else:
        want = jval.validate_fields(sj, PARAMS_J, raise_on_fail=False)
        got = validator.validate_fields(st, PARAMS, raise_on_fail=False)
    for r in (got, want):
        if entry == "fields":       # the stored fields lag: both fail
            assert r.rho_max_rel > validator.REL_TOL
            assert r.acc_max_rel == r.acc_max_abs == 0.0
        else:                       # both pass the validator's tolerances
            assert r.rho_max_rel <= validator.REL_TOL
            assert r.p_max_rel <= validator.REL_TOL
            assert (r.acc_max_rel <= validator.REL_TOL
                    or r.acc_max_abs <= validator.ACC_ABS_TOL)
    _report_close(got, want, slack)
    assert str(got).startswith("parity: rho")


def test_validator_injected_errors_match_jax(validated_state):
    """``validate`` on the accelerated state with known errors added (rho
    scaled by 1 + 4e-3, p + 0.5, ax + 0.1, ay - 0.1), so that every metric
    sits far above the golden models' gap: both packages' reports agree
    within it, and each injected metric lies where the injection puts it
    (each package's clean report bounds its distance from the injected
    value, up to the rounding of the addition).  A validator that reported
    no error, or the clean error, would fail here."""
    _, st = validated_state
    at, _ = grid_solver.compute_rho_p_acc(st, PARAMS, EGRID_T)
    tt, tj = _golden_pair(at)
    clean = (validator.validate(at, PARAMS),
             jval.validate(_to_jax(at), PARAMS_J))
    bad = at.replace(rho=at.rho * np.float32(1.0 + 4e-3), p=at.p + 0.5,
                     ax=at.ax + 0.1, ay=at.ay - 0.1)
    got = validator.validate(bad, PARAMS, raise_on_fail=False)
    want = jval.validate(_to_jax(bad), PARAMS_J, raise_on_fail=False)
    _report_close(got, want, _gaps(tt, tj))
    min_d = float(torch.clamp_min(torch.cat([tt.ax, tt.ay]).abs(), 1.0).min())
    for r, c in zip((got, want), clean):
        assert abs(r.rho_max_rel - 4e-3) <= (1 + 4e-3) * c.rho_max_rel + 1e-6
        assert abs(r.p_max_abs - 0.5) <= c.p_max_abs + _ulp(bad.p)
        assert abs(r.acc_max_abs - 0.1) <= c.acc_max_abs + _ulp(bad.ax,
                                                                bad.ay)
        assert abs(r.acc_max_rel - 0.1 / min_d) <= c.acc_max_rel + 1e-6


@pytest.mark.parametrize("entry", ["validate", "accelerated", "fields"])
def test_validator_raises_on_corruption(entry, validated_state):
    """A 5% density error (or, for the accelerated check, forces scaled by
    1.5) raises ParityError with the worst offenders, as JAX's does;
    raise_on_fail=False returns the failing report instead."""
    _, st = validated_state
    if entry == "accelerated":
        density_fn, forces_fn = cuda_solver.make_stencils(EGRID_T)

        def bad_forces(*a, **kw):
            return tuple(f * 1.5 for f in forces_fn(*a, **kw))
        call = lambda **kw: validator.validate_accelerated(
            st, PARAMS, EGRID_T, (density_fn, bad_forces), **kw)
    else:
        at, _ = grid_solver.compute_rho_p_acc(st, PARAMS, EGRID_T)
        bad = at.replace(rho=at.rho * 1.05)
        fn = validator.validate if entry == "validate" \
            else validator.validate_fields
        call = lambda **kw: fn(bad, PARAMS, **kw)
    with pytest.raises(validator.ParityError, match="offenders"):
        call()
    assert isinstance(call(raise_on_fail=False), validator.ParityReport)


# --------------------------------------------------------------- facade

def test_simulation_dam_break_grid():
    """The eager solvers' dam break bins into cells of h, as JAX's."""
    sim = bt.Simulation.dam_break(n=64, solver="xla", device="cpu")
    assert sim.grid == grid_solver.default_grid(0.045, -5.0, 3.0, 4.0)
    assert sim.grid == convert.grid_from(
        jgs.default_grid(0.045, -5.0, 3.0, y_max=4.0))


@pytest.mark.parametrize("solver", ["pallas", "xla"])
def test_simulation_eager_solvers(solver):
    """``Simulation(solver="pallas" | "xla")`` on a small box steps,
    renders frames that are not black, tracks overflow, validates every K
    steps in ``run`` (not in ``run_frame``) and returns nothing from
    ``run``."""
    cfg = bt.IntegrateConfig.create(x_min=-0.5, x_max=1.0)
    grid = grid_solver.default_grid(0.045, -0.5, 1.0, y_max=1.2)
    sim = bt.Simulation(bt.init_grid(16, 16, 0.04, "cpu"), PARAMS, cfg,
                        grid, solver=solver, raster_width=128,
                        validate_every=2, device="cpu")
    assert sim.run(2) is None
    assert sim.last_parity is not None
    assert sim.last_parity.acc_max_abs > 0.0          # full mode
    assert sim.last_parity.rho_max_rel <= 0.01
    first = sim.last_parity
    img = sim.run_frame(2)
    assert img.dtype == torch.uint8 and int(img.int().sum(-1).max()) > 30
    assert sim.last_parity is first
    imgs = sim.run_frames(2, substeps=1, mode="field")
    assert imgs.shape[0] == 2 and int(imgs.int().sum(-1).max()) > 30
    assert sim.overflow == 0 and sim.state.step == 6
    assert sim.validate(mode="fields").acc_max_abs == 0.0


def test_simulation_validate_every_on_verlet():
    """The verlet engine: ``validate_every`` runs the full check through
    K1 + K8 on the Session's extracted state."""
    sim = bt.Simulation.dam_break(n=256, device="cpu", validate_every=10)
    sim.run(6)
    assert sim.last_parity is None
    sim.run(6)
    assert sim.last_parity is not None
    assert sim.last_parity.acc_max_abs > 0.0
    assert sim.last_parity.rho_max_rel <= 0.01
    assert sim.validate(mode="fields").rho_max_rel <= 0.01


# --------------------------------------------------------------- Session

def test_unfused_session_matches_fused():
    """``Session(stencils=make_stencils(grid))`` (K1, K8, torch integrate)
    takes the same steps as the fused Session (bitwise on the CPU twins);
    ``Session(stencils=XLA_STENCILS)`` (the hard-gated plain stencils)
    tracks it through the same rebins, within the two gate forms'
    difference."""
    sj = jittered_state(seed=5, side=12)
    st = convert.state_from(_np(sj), "cpu")
    # 12 row blocks: the fused Session steps on K1 + K2, not on K5
    runs = [tvs.Session(st, PARAMS, CFG, VGRID12_T, device="cpu",
                        stencils=stencils)
            for stencils in (None, cuda_solver.make_stencils(VGRID12_T),
                             grid_solver.XLA_STENCILS)]
    for sess in runs:
        sess.run(12)
    fused, k8, xla = runs
    for f in ("xd", "yd", "vxd", "vyd", "rho_d", "idx_d"):
        assert torch.equal(getattr(fused.sim, f), getattr(k8.sim, f)), f
    assert fused.sim.rebin_count == k8.sim.rebin_count >= 2
    assert xla.sim.rebin_count == fused.sim.rebin_count
    assert torch.equal(xla.sim.idx_d, fused.sim.idx_d)
    a, b = xla.state(), fused.state()
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.rho.numpy(), b.rho.numpy(), rtol=1e-4)
