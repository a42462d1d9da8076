"""The port's API against the reference's, on the CPU: ``verlet_solver.
multi_step`` with ``stencils=`` and a ``StepDiag`` return, the slab step's
default (the unfused step, as the reference's), and K7's ``out=``.

``multi_step`` is held against JAX's for both stencil pairs: the plain
stencils (``XLA_STENCILS`` on both sides, cells of 4 slots) and the
kernels' (JAX's Pallas density and forces in interpret mode, the port's
K1 + K8 twins, cells of 8), over 10 steps of a 16 x 16 lattice kicked to
vx = 4 so that the skin trigger fires.  Rebins and the overflow count
are exact; positions 1e-6 absolute, velocities 1e-4 absolute, density
1e-5 relative (tests/test_torch_session.py's bars: the same pair sums in
the same order, FP contraction aside).

K7 ``out=`` is bitwise its fresh-output call, written in full over a
garbage plane; a mismatched or overlapping ``out`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import grid_solver as jgs
from bevy_gpu_fluid_tpu.models import pallas_solver as jps
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot
from bevy_gpu_fluid_tpu_torch.parallel import shard as tsh
from bevy_gpu_fluid_tpu_torch.parallel import shard_verlet as tsv
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import ShardedSession
from bevy_gpu_fluid_tpu_torch.utils import convert

torch.set_num_threads(1)

PARAMS_J = bgf.FluidParams.demo()
CFG_J = bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
VGRID_J = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0, cap=8,
                           skin_factor=1.5)
# the plain stencils' scan compiles for ~2x as long at cap 8 as at cap 4
# (the unrolled pair taps), so their pair runs on cells of 4 slots
VGRID4_J = jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0, cap=4,
                            skin_factor=1.5)
PARAMS = convert.params_from(PARAMS_J)
CFG = convert.cfg_from(CFG_J)
VGRID = convert.grid_from(VGRID_J)
F3_STEPS = 10


@pytest.mark.parametrize("pair", ["xla", "kernels"])
def test_multi_step_stencils_match_jax(pair):
    state_j = bgf.init_grid(16, 16, 0.04)
    state_j = state_j.replace(vx=jnp.full((state_j.n,), 4.0))
    if pair == "xla":
        grid_j = VGRID4_J
        sj, st = jgs.XLA_STENCILS, grid_solver.XLA_STENCILS
    else:
        grid_j = VGRID_J
        sj = jps.make_stencils(VGRID_J, interpret=True)
        st = cuda_solver.make_stencils(VGRID)
    want, wdiag, wrebins = jvs.multi_step(state_j, PARAMS_J, CFG_J, grid_j,
                                          F3_STEPS, stencils=sj)
    got, diag, rebins = tvs.multi_step(
        convert.state_from(jax.tree_util.tree_map(np.asarray, state_j),
                           "cpu"), PARAMS, CFG, convert.grid_from(grid_j),
        F3_STEPS, stencils=st)
    assert isinstance(diag, grid_solver.StepDiag)
    assert rebins == int(wrebins) >= 2
    assert diag.overflow == int(wdiag.overflow) == 0
    assert got.step == int(want.step) == F3_STEPS
    for f, tol in (("x", 1e-6), ("y", 1e-6), ("vx", 1e-4), ("vy", 1e-4)):
        err = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
        assert err.max() <= tol, (f, err.max())
    rho_j = np.asarray(want.rho)
    assert (np.abs(got.rho.numpy() - rho_j) / rho_j).max() <= 1e-5


def _counting(monkeypatch, name):
    """Count the calls of ``cuda_solver.<name>`` (K2's wrapper runs its
    twin on the CPU, where no launch is counted)."""
    calls = []
    real = getattr(cuda_solver, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(cuda_solver, name, wrapper)
    return calls


def _slab_scene():
    """A 12 x 12 lattice drifting at vx = 5 across two slabs of a shallow
    grid (the skin trigger fires after ~5 steps)."""
    state = bt.init_grid(12, 12, 0.04, "cpu")
    state = state.replace(vx=torch.full((state.n,), 5.0))
    spec = tsh.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                               y_max=1.0, n_devices=2, capacity=512)
    return state, spec, SlabMesh(["cpu"] * 2)


def _slab_run(steps_fn, state, spec, mesh, n_steps=7):
    sim = steps_fn.init(tsh.shard_state(state, spec, mesh))
    for _ in range(n_steps):
        sim = steps_fn.step(sim)
    return sim


def test_sharded_step_defaults_to_unfused(monkeypatch):
    """``make_sharded_verlet_step``'s default is the reference's: the
    unfused step on the plain stencils, bitwise an explicit
    ``fused=False``, with no K2 call; ``fused=True`` calls K2."""
    state, spec, mesh = _slab_scene()
    calls = _counting(monkeypatch, "forces_integrate_cuda")
    default = _slab_run(tsv.make_sharded_verlet_step(
        PARAMS, CFG, spec, mesh, n=state.n), state, spec, mesh)
    assert calls == [] and default.rebin_count >= 2
    explicit = _slab_run(tsv.make_sharded_verlet_step(
        PARAMS, CFG, spec, mesh, n=state.n, fused=False), state, spec, mesh)
    for name in ("xd", "yd", "vxd", "vyd", "rho_d", "idx_d"):
        for a, b in zip(getattr(default, name), getattr(explicit, name)):
            assert torch.equal(a, b), name
    assert default.rebin_count == explicit.rebin_count
    assert calls == []
    _slab_run(tsv.make_sharded_verlet_step(PARAMS, CFG, spec, mesh,
                                           n=state.n, fused=True),
              state, spec, mesh, 1)
    assert len(calls) == spec.n_devices


def test_sharded_session_still_runs_k2(monkeypatch):
    """``ShardedSession`` keeps its own default, the fused step: K2 once
    per slab and step."""
    state, spec, mesh = _slab_scene()
    calls = _counting(monkeypatch, "forces_integrate_cuda")
    ShardedSession(state, PARAMS, CFG, spec, mesh).run(3)
    assert len(calls) == 3 * spec.n_devices


class _Stop(Exception):
    pass


@pytest.mark.parametrize("caller", ["ShardedSession", "dryrun_multichip",
                                    "export_sharded_run"])
def test_fused_callers_say_so(caller, monkeypatch, tmp_path):
    """Every caller that means the fused slab step passes ``fused=True``:
    the recorded argument of its ``make_sharded_verlet_step`` call."""
    from bevy_gpu_fluid_tpu_torch import entry
    from bevy_gpu_fluid_tpu_torch.utils import aot

    state, spec, mesh = _slab_scene()
    sess = ShardedSession(state, PARAMS, CFG, spec, mesh)
    seen = []

    def record(*a, **kw):
        seen.append(kw.get("fused", "default"))
        raise _Stop
    monkeypatch.setattr(tsv, "make_sharded_verlet_step", record)
    with pytest.raises(_Stop):
        {"ShardedSession": lambda: ShardedSession(state, PARAMS, CFG, spec,
                                                  mesh),
         "dryrun_multichip": lambda: entry.dryrun_multichip(2, "cpu"),
         "export_sharded_run": lambda: aot.export_sharded_run(
             sess, 1, str(tmp_path / "a.pt2"))}[caller]()
    assert seen == [True]


# ---- K7 out= ---------------------------------------------------------------

def _code_scene(code_dtype):
    """Port planes of a 20 x 20 lattice with every live particle moved by
    up to 0.95 of half the skin (numpy seed), their ``block_kmax3`` and
    K6's code (its twin)."""
    sim = tvs.init_dense(bt.init_grid(20, 20, 0.04, "cpu"), VGRID)
    live = sim.xd < 5e8
    skin_half = (VGRID.cell_size - 0.045) * 0.5
    d = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.95, 0.95, (2,) + tuple(sim.xd.shape)).astype(np.float32))
    xd = torch.where(live, sim.xd + d[0] * skin_half, sim.xd)
    yd = torch.where(live, torch.clamp_min(sim.yd + d[1] * skin_half, 0.0),
                     sim.yd)
    occ = reslot.block_kmax3(xd, VGRID)
    code, _ = reslot.select_cuda(xd, yd, VGRID, occ, code_dtype)
    return {"xd": xd, "idx_d": sim.idx_d}, occ, code


@pytest.mark.parametrize("payload", ["xd", "idx_d"])
@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("fn", ["apply_code_cuda", "apply_code_torch"])
def test_apply_code_out_bitwise_fresh(payload, code_dtype, fn):
    planes, occ, code = _code_scene(code_dtype)
    plane = planes[payload]
    fill = 1e9 if payload == "xd" else -1
    apply = getattr(reslot, fn)
    fresh = apply(plane, code, occ, VGRID, fill)
    out = torch.full_like(plane, 7)      # garbage: every slot is written
    got = apply(plane, code, occ, VGRID, fill, out=out)
    assert got is out and got.dtype == plane.dtype
    assert torch.equal(got.view(torch.int32), fresh.view(torch.int32))
    assert int((code >= 0).sum()) > 300


@pytest.mark.parametrize("bad", ["shape", "dtype", "payload", "overlap"])
def test_apply_code_out_refused(bad):
    planes, occ, code = _code_scene(torch.int32)
    xd = planes["xd"]
    big = torch.empty(xd.numel() * 2, dtype=xd.dtype)
    out = {"shape": torch.empty(xd.shape[0] + 1, *xd.shape[1:]),
           "dtype": torch.empty(xd.shape, dtype=torch.int32),
           "payload": xd,
           "overlap": None}[bad]
    payload = xd
    if bad == "overlap":
        # a payload and an out that share half their words
        half = xd.numel() // 2
        payload = big[:xd.numel()].view(xd.shape).copy_(xd)
        out = big[half:half + xd.numel()].view(xd.shape)
    for fn in (reslot.apply_code_cuda, reslot.apply_code_torch):
        with pytest.raises(ValueError):
            fn(payload, code, occ, VGRID, 1e9, out=out)
