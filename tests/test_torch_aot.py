"""The port's ahead-of-time export (utils/aot.py): the JAX package's
tests/test_aot.py cases on the port, on the CPU.

An artifact holds the Session's pure step and reslot traced through the
kernels as torch.library operators (kernels/ops.py; on CPU tensors each
runs its kernel's PyTorch twin); the loader drives them with the port's
own trigger and rebin.  So a loaded run is BITWISE the live Session's run
from the same snapshot (every field, integers and floats), also in a
fresh process, and stateless.  Against the JAX Session's run(5) on the
same scene the gate is the Session gate of tests/test_torch_session.py:
integers exact, positions 1e-5 and velocities 1e-4 absolute, rho 1e-5
relative.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu as bgf
from bevy_gpu_fluid_tpu.models import verlet_solver as jvs

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.kernels import ops
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops.reslot import block_kmax3
from bevy_gpu_fluid_tpu_torch.parallel import shard
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import ShardedSession
from bevy_gpu_fluid_tpu_torch.utils import aot

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = bt.FluidParams.demo()
CFG = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0, cap=8)   # 7 row blocks
VX = 6.0   # moves past half the skin within 5 steps: a rebin in the run


def _state(side=12):
    s = bt.init_grid(side, side, 0.04, "cpu")
    return s.replace(vx=torch.full((s.n,), VX))


def _equal(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _sims_equal(a, b) -> bool:
    return all(_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.fixture(scope="module")
def session_artifact(tmp_path_factory):
    """A Session, its snapshot, its checkpoint, and its 5-step artifact."""
    d = tmp_path_factory.mktemp("aot")
    sess = vs.Session(_state(), PARAMS, CFG, GRID, device="cpu")
    sim0 = sess.sim
    path = os.fspath(d / "run5.bgfexp")
    ckpt = os.fspath(d / "snap.npz")
    sess.save(ckpt)
    aot.export_session_run(sess, 5, path)
    sess.run(5)
    return sess, sim0, path, ckpt


def test_exported_session_run_roundtrip(session_artifact):
    sess, sim0, path, _ = session_artifact
    loaded = aot.load_exported(path, out_like=sim0)
    out = loaded(sim0)
    assert out.rebin_count == sess.sim.rebin_count >= 2   # a rebin inside
    assert out.step == 5
    assert _sims_equal(out, sess.sim)
    # stateless: the SAME snapshot again gives the same result
    assert _sims_equal(loaded(sim0), out)
    assert loaded.meta["kind"] == "session" and loaded.meta["n_steps"] == 5


def test_exported_session_run_fresh_process(session_artifact, tmp_path):
    """A fresh interpreter restores the checkpoint, loads the artifact and
    runs it: bitwise the live Session."""
    sess, _, path, ckpt = session_artifact
    out_npz = os.fspath(tmp_path / "out.npz")
    code = (
        "import sys, dataclasses, numpy as np, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs\n"
        "from bevy_gpu_fluid_tpu_torch.utils import aot\n"
        f"s = vs.Session.restore({ckpt!r}, device='cpu')\n"
        f"out = aot.load_exported({path!r}, out_like=s.sim)(s.sim)\n"
        f"np.savez({out_npz!r}, **{{f.name: np.asarray(getattr(out, f.name))"
        " for f in dataclasses.fields(out)})\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    with np.load(out_npz) as z:
        for f in dataclasses.fields(sess.sim):
            want = getattr(sess.sim, f.name)
            got = z[f.name]
            if isinstance(want, torch.Tensor):
                assert got.dtype == want.numpy().dtype, f.name
                np.testing.assert_array_equal(got, want.numpy(), f.name)
            else:
                assert int(got) == want, f.name


def test_exported_run_matches_the_jax_session(session_artifact):
    """The loaded artifact's 5 steps against the JAX Session's run(5) on
    the same scene (interpret-mode Pallas, its XLA rebin)."""
    _, sim0, path, _ = session_artifact
    out = aot.load_exported(path, out_like=sim0)(sim0)
    st = bgf.init_grid(12, 12, 0.04)
    st = st.replace(vx=jnp.full((st.n,), VX))
    sj = jvs.Session(st, bgf.FluidParams.demo(),
                     bgf.IntegrateConfig.create(x_min=-1.0, x_max=2.5),
                     jvs.default_grid(0.045, -1.0, 2.5, y_max=3.0, cap=8))
    sj.run(5)
    j = jax.tree_util.tree_map(np.asarray, sj.sim)
    assert out.rebin_count == int(j.rebin_count)
    assert out.step == int(j.step) == 5
    assert out.overflow == int(j.overflow) and out.lost == int(j.lost) == 0
    np.testing.assert_array_equal(out.idx_d.numpy(), j.idx_d)
    np.testing.assert_array_equal(out.occ.numpy(), j.occ)
    live = j.idx_d >= 0
    for name, atol in (("xd", 1e-5), ("yd", 1e-5), ("vxd", 1e-4),
                       ("vyd", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy()[live],
                                   getattr(j, name)[live], rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(out.rho_d.numpy()[live], j.rho_d[live],
                               rtol=1e-5)


def test_exported_sharded_run_roundtrip(tmp_path):
    """The slab pure step (halo, K1 + K2 per slab) exports as one graph;
    the collective rebin is rebuilt: bitwise the live D=2 run."""
    spec = shard.ShardSpec.build(h=0.045 * 1.5, x_min=-1.0, x_max=2.5,
                                 y_max=3.0, n_devices=2, capacity=1024)
    state = bt.init_grid(20, 6, 0.04, "cpu")
    state = state.replace(x=state.x - 0.9, vx=torch.full((state.n,), 3.0))
    sess = ShardedSession(state, PARAMS, CFG, spec, SlabMesh(["cpu"] * 2))
    sim0 = sess.sim
    path = os.fspath(tmp_path / "shard3.bgfexp")
    sess.export_run(3, path)          # aot.export_sharded_run(sess, 3, path)
    loaded = aot.load_exported(path, out_like=sim0)
    out = loaded(sim0)
    sess.run(3)
    assert _sims_equal(out, sess.sim)
    assert sum(out.alive) == state.n
    assert _sims_equal(loaded(sim0), out)          # stateless


def test_exported_flat_outputs_without_template(session_artifact):
    # without out_like the loader hands back the fields in order
    _, sim0, path, _ = session_artifact
    flat = aot.load_exported(path)(sim0)
    assert isinstance(flat, tuple)
    assert len(flat) == len(dataclasses.fields(vs.DenseSim))
    assert flat[-2] == 5                           # step


def test_exported_fn_through_an_operator(tmp_path):
    """A plain function over K1's operator: saved, loaded, bitwise the
    wrapper."""
    s = vs.Session(_state(), PARAMS, CFG, GRID, device="cpu").sim
    path = os.fspath(tmp_path / "k1.bgfexp")
    aot.save_exported(path, lambda x, y, occ: ops.density_cuda(
        x, y, PARAMS, GRID, occ), s.xd, s.yd, s.occ)
    (rho,) = aot.load_exported(path)(s.xd, s.yd, s.occ)
    want = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    assert torch.equal(rho, want)
    assert torch.equal(block_kmax3(s.xd, GRID), s.occ)


@pytest.mark.parametrize("knob,name", [
    (dict(donate=True), "donate"),
    (dict(planar_rebin=True), "planar_rebin"),
    (dict(stencils=cuda_solver.make_stencils(GRID)), "stencils")])
def test_refused_postures_raise_with_their_name(tmp_path, knob, name):
    sess = vs.Session(_state(8), PARAMS, CFG, GRID, device="cpu", **knob)
    with pytest.raises(ValueError, match=name):
        aot.export_session_run(sess, 2, os.fspath(tmp_path / "x.bgfexp"))
    assert not (tmp_path / "x.bgfexp").exists()
