"""The reference's kernel experiments (the repo's ``tools/exp_*.py``)
against the port's twins of T1-T4 (``models/exp_kernels.py``) and the
port's tools (``bevy_gpu_fluid_tpu_torch/tools/exp_*.py``), on the CPU.

The scene is the tools' 40 x 40 dam break (cells 1.75 h), its velocities
jittered from a numpy seed, after 30 port Session steps; its planes go to
both packages as numpy arrays, rho from K1's twin, the rebin references
jittered from the seed so the displacement max is not trivial.  The JAX
side runs each tool's Pallas kernel in interpret mode, as the JAX
package's own tests run its kernels: ``exp_tlayout`` picks interpret mode
off the TPU itself, ``exp_dbuf`` and ``exp_forces`` hard-code
``interpret=False``, so their tests substitute a ``pl.pallas_call`` that
sets it.  Importing a reference tool points JAX's compilation cache at the
tool's own directory; the module puts back the setting it found.

Tolerances, and why (the production counterparts' gates):
* T1 against ``make_dbuf``: x, y 1e-6 absolute, vx, vy 1e-4 of max |v|,
  the displacement max 1e-4 relative (K2's twin against
  ``forces_integrate_pallas``: one step of the same arithmetic);
* T2 against ``density_t``: 1e-5 relative on live slots (K1's);
* T3 against ``forces_t`` and T4 against ``make_forces``, every variant:
  1e-5 of the plane's max |a| (K8's), on the interior row blocks, which
  are all the TPU kernels write.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

from bevy_gpu_fluid_tpu_torch import tools
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import exp_kernels as ek
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.tools import exp_dbuf, exp_forces, exp_tlayout

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 1600          # 40 x 40
STEPS = 30
SKIN = 1.75


def _reference_tool(name):
    """The repo's ``tools/<name>.py`` as a module, JAX's compilation cache
    directory put back as the tool's import found it."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mod


ref_dbuf = _reference_tool("exp_dbuf")
ref_forces = _reference_tool("exp_forces")
ref_tlayout = _reference_tool("exp_tlayout")


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the tools that hard-code
    ``interpret=False``."""
    from jax.experimental import pallas as pl
    call = pl.pallas_call

    def forced(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(pl, "pallas_call", forced)


@pytest.fixture(scope="module")
def scene():
    """The port's sim, Scene and rho, and the JAX grid, params and
    cfg."""
    rng = np.random.default_rng(12)
    sc = tools.dam_break(N, "cpu", SKIN)
    st = sc.state
    state = st.replace(
        vx=torch.from_numpy(rng.normal(0, 0.5, st.n).astype(np.float32)),
        vy=torch.from_numpy(rng.normal(0, 0.5, st.n).astype(np.float32)))
    sess = tvs.Session(state, sc.params, sc.cfg, sc.grid, device="cpu")
    sess.run(STEPS)
    sim = sess.sim
    live = sim.xd < 5e8
    shift = torch.from_numpy(
        rng.uniform(-0.004, 0.004, (2, *sim.xd.shape)).astype(np.float32))
    sim.ref_xd = torch.where(live, sim.xd + shift[0], sim.xd)
    sim.ref_yd = torch.where(live, sim.yd + shift[1], sim.yd)
    rho = cuda_solver.density_cuda(sim.xd, sim.yd, sc.params, sc.grid,
                                   sim.occ)
    extent = sc.extent
    jgrid = jvs.default_grid(0.045, -1.0, extent + 1.0,
                             y_max=extent * 1.1 + 1.0, cap=8,
                             skin_factor=SKIN)
    assert (jgrid.ny_pad, jgrid.cap, jgrid.nx_pad) == sc.grid.plane_shape
    assert jgrid.row_block == sc.grid.row_block
    assert int(live.sum()) == N
    return dict(sim=sim, sc=sc, rho=rho, jgrid=jgrid,
                jparams=bgf.FluidParams.demo(),
                jcfg=bgf.IntegrateConfig.create(x_min=-1.0,
                                                x_max=extent + 1.0))


def _j(t):
    return jnp.asarray(t.numpy())


def _interior(a, tb, axis=0):
    a = np.asarray(a)
    return a[tb:-tb] if axis == 0 else a[:, tb:-tb]


# ------------------------------------------------------------- T1

def test_dbuf_twin_matches_reference(scene, interpret):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    planes = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sim.ref_xd, sim.ref_yd)
    fn = ref_dbuf.make_dbuf(scene["jgrid"], scene["jcfg"], scene["jparams"])
    want = fn(*(_j(p) for p in planes), _j(sim.occ))
    got = ek.forces_integrate_dbuf_torch(*planes, sc.params, sc.cfg, sc.grid,
                                         sim.occ)
    tb = sc.grid.row_block
    for i in range(2):
        np.testing.assert_allclose(_interior(got[i], tb),
                                   _interior(want[i], tb), rtol=0,
                                   atol=1e-6)
    vscale = max(np.abs(_interior(want[i], tb)).max() for i in (2, 3))
    assert vscale > 0.5
    for i in (2, 3):
        np.testing.assert_allclose(_interior(got[i], tb),
                                   _interior(want[i], tb), rtol=0,
                                   atol=1e-4 * vscale)
    wd = float(jnp.max(want[4]))
    assert wd > 0 and abs(float(got[4]) - wd) <= 1e-4 * wd
    # the twin is K2's, and the wrapper's CPU path is the twin
    k2 = cuda_solver.forces_integrate_cuda(*planes, sc.params, sc.cfg,
                                           sc.grid, sim.occ)
    wrapped = ek.forces_integrate_dbuf_cuda(*planes, sc.params, sc.cfg,
                                            sc.grid, sim.occ)
    for a, b, c in zip(got, k2, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------------------------- T2, T3

@pytest.fixture(scope="module")
def slot_major(scene):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt = ek.to_slot_major(sim.xd), ek.to_slot_major(sim.yd)
    occ_t = ek.block_kmax3_t(xt, sc.grid)
    assert torch.equal(occ_t, sim.occ)
    return xt, yt, occ_t


def test_density_t_twin_matches_reference(scene, slot_major):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt, occ_t = slot_major
    want = np.asarray(ref_tlayout.density_t(_j(xt), _j(yt), scene["jparams"],
                                            scene["jgrid"]))
    got = ek.density_t_cuda(xt, yt, sc.params, sc.grid, occ_t)
    tb = sc.grid.row_block
    live = _interior(xt.numpy() < 5e8, tb, axis=1)
    np.testing.assert_allclose(_interior(got, tb, axis=1)[live],
                               _interior(want, tb, axis=1)[live], rtol=1e-5)
    # bitwise K1's twin after movedim, ghost blocks 0 included
    assert torch.equal(ek.from_slot_major(got), scene["rho"])


def test_forces_t_twin_matches_reference(scene, slot_major):
    sim, sc = scene["sim"], scene["sc"]
    xt, yt, occ_t = slot_major
    vxt, vyt = ek.to_slot_major(sim.vxd), ek.to_slot_major(sim.vyd)
    rhot = ek.to_slot_major(scene["rho"])
    want = ref_tlayout.forces_t(_j(xt), _j(yt), _j(vxt), _j(vyt), _j(rhot),
                                scene["jparams"], scene["jgrid"])
    got = ek.forces_t_cuda(xt, yt, vxt, vyt, rhot, sc.params, sc.grid,
                           occ_t)
    tb = sc.grid.row_block
    w = [_interior(a, tb, axis=1) for a in want]
    scale = max(np.abs(a).max() for a in w)
    assert scale > 1.0
    for g, a in zip(got, w):
        np.testing.assert_allclose(_interior(g, tb, axis=1), a, rtol=0,
                                   atol=1e-5 * scale)
    # K8's function: within the same gate of K8's twin
    k8 = cuda_solver.forces_torch(sim.xd, sim.yd, sim.vxd, sim.vyd,
                                  scene["rho"], sc.params, sc.grid, sim.occ)
    for g, a in zip(got, k8):
        np.testing.assert_allclose(ek.from_slot_major(g).numpy(), a.numpy(),
                                   rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------------- T4

@pytest.mark.parametrize("variant", ek.VARIANTS)
def test_forces_variant_twin_matches_reference(scene, interpret, variant):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    planes = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho)
    want = ref_forces.make_forces(scene["jgrid"], variant)(
        *(_j(p) for p in planes), scene["jparams"])
    got = ek.forces_variant_cuda(*planes, sc.params, sc.grid, sim.occ,
                                 variant)
    tb = sc.grid.row_block
    w = [_interior(a, tb) for a in want]
    scale = max(np.abs(a).max() for a in w)
    assert np.isfinite(scale) and scale > 1.0
    for g, a in zip(got, w):
        np.testing.assert_allclose(_interior(g, tb), a, rtol=0,
                                   atol=1e-5 * scale)


def test_forces_variants_agree_as_designed(scene):
    """v0 is K8's twin and v3 v2's, bit for bit; v1 and v2 within K8's
    gate of v0; v0nr is not K8's function."""
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    args = (sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sc.params, sc.grid,
            sim.occ)
    a = {v: ek.forces_variant_torch(*args, v) for v in ek.VARIANTS}
    k8 = cuda_solver.forces_torch(*args)
    assert all(torch.equal(u, w) for u, w in zip(a["v0"], k8))
    assert all(torch.equal(u, w) for u, w in zip(a["v3"], a["v2"]))
    scale = float(torch.maximum(k8[0].abs().max(), k8[1].abs().max()))
    for v in ("v1", "v2"):
        assert max(float((u - w).abs().max())
                   for u, w in zip(a[v], k8)) <= 1e-5 * scale
    assert max(float((u - w).abs().max())
               for u, w in zip(a["v0nr"], k8)) > 1e-3 * scale
    with pytest.raises(ValueError):
        ek.forces_variant_cuda(*args, "v4")


def test_wrappers_check_planes_and_count_only_launches(scene, slot_major):
    sim, sc, rho = scene["sim"], scene["sc"], scene["rho"]
    xt, yt, occ_t = slot_major
    with pytest.raises(ValueError):       # dense planes where slot-major
        ek.density_t_cuda(sim.xd, sim.yd, sc.params, sc.grid, occ_t)
    with pytest.raises(ValueError):
        ek.forces_variant_cuda(sim.xd.double(), sim.yd, sim.vxd, sim.vyd,
                               rho, sc.params, sc.grid, sim.occ, "v1")
    before = tools.launch_counts()
    ek.density_t_cuda(xt, yt, sc.params, sc.grid, occ_t)
    ek.forces_variant_cuda(sim.xd, sim.yd, sim.vxd, sim.vyd, rho, sc.params,
                           sc.grid, sim.occ, "v3")
    assert set(tools.launches_since(before).values()) == {0}   # twins
    assert {"forces_integrate_dbuf", "density_t", "forces_t",
            *(f"forces_variant_{v}" for v in ek.VARIANTS)} \
        <= set(before)


# ------------------------------------------------------------- the tools

def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_exp_forces_main(capsys):
    assert exp_forces.main(["--cpu", "--n", str(N), "--iters", "1",
                            "--steps", str(STEPS)]) == 0
    lines = _lines(capsys)
    for v in ek.VARIANTS:
        assert any(ln.startswith(f"pass0 {v} ") for ln in lines)
        assert any(ln.startswith(f"pass1 {v} ") for ln in lines)
        assert any(ln.startswith(f"{v:6s} best ") for ln in lines)
    for v in ("v1", "v2", "v3"):
        assert any(ln.startswith(f"{v} vs v0 interior max abs diff: ")
                   for ln in lines)
    out = json.loads(lines[-1])
    assert out["ok"] and out["n"] == N and out["device"] == "cpu"
    assert out["diff_vs_v0"]["v3"] == out["diff_vs_v0"]["v2"]


def test_exp_tlayout_main(capsys):
    assert exp_tlayout.main(["--cpu", "--n", str(N), "--iters", "1"]) == 0
    lines = _lines(capsys)
    for prefix in ("# max |rho_t - rho_cur| = ",
                   "density current [rows,cap,nx]: ",
                   "density transposed [cap,rows,nx]: ",
                   "forces current [rows,cap,nx]: ",
                   "forces transposed [cap,rows,nx]: "):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    out = json.loads(lines[-1])
    assert out["ok"] and out["rho_max_abs_diff"] == 0.0


def test_exp_dbuf_main(capsys):
    assert exp_dbuf.main(["--cpu", "--n", str(N), "--iters", "1",
                          "--steps", str(STEPS)]) == 0
    lines = _lines(capsys)
    assert any(ln.startswith("production fused : ") for ln in lines)
    assert any(ln.startswith("double-buffered  : ") for ln in lines)
    for i in range(4):
        assert f"out[{i}] interior max abs diff: 0.000e+00" in lines
    out = json.loads(lines[-1])
    assert out["ok"] and out["planes_equal"]


@pytest.mark.parametrize("tool", [exp_forces, exp_tlayout, exp_dbuf])
def test_exp_tools_need_the_card_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--n", str(N)])


def test_reference_tools_leave_the_cache_setting():
    assert jax.config.jax_compilation_cache_dir == os.path.expanduser(
        "~/.jax_cache_cpu")
