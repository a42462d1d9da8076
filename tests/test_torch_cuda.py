"""The port's CUDA kernels on the card, against their PyTorch twins.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the kernels are built
for sm_90a on first use); without a GPU they skip.  They import no JAX, so
they run on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: K3 (reslot) bitwise; K1 1e-5 relative on live slots; K2
positions 1e-5 absolute, velocities 1e-4 of the plane's max |v|, disp2 1e-4
relative.  The kernels contract multiply-adds into FMAs and use the
hardware rsqrt; the twins round every operation.
"""

import numpy as np
import pytest
import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops import reslot

pytestmark = pytest.mark.cuda

PARAMS = bt.FluidParams.demo()
CFG = bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5)
GRID = vs.default_grid(0.045, -1.0, 2.5, y_max=6.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def moving_sim(cuda):
    """The kicked 24x24 block after 25 steps on the card (a rebin or two
    in), and its particle count."""
    state = bt.init_grid(24, 24, 0.04, cuda)
    state = state.replace(vx=torch.full((state.n,), 2.0, device=cuda))
    sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda)
    sess.run(25)
    return sess.sim


def test_density_kernel_matches_twin(moving_sim):
    s = moving_sim
    got = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    want = cuda_solver.density_torch(s.xd, s.yd, PARAMS, GRID, s.occ)
    live = s.xd < 5e8
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[live]
    assert float(rel.max()) <= 1e-5
    tb = GRID.row_block
    assert bool((got[:tb] == 0).all() & (got[-tb:] == 0).all())


def test_forces_integrate_kernel_matches_twin(moving_sim):
    s = moving_sim
    rho = cuda_solver.density_cuda(s.xd, s.yd, PARAMS, GRID, s.occ)
    args = (s.xd, s.yd, s.vxd, s.vyd, rho, s.ref_xd, s.ref_yd, PARAMS, CFG,
            GRID, s.occ)
    got = cuda_solver.forces_integrate_cuda(*args)
    want = cuda_solver.forces_integrate_torch(*args)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-5
    vscale = float(torch.maximum(want[2].abs().max(), want[3].abs().max()))
    for g, w in zip(got[2:4], want[2:4]):
        assert float((g - w).abs().max()) <= 1e-4 * vscale
    assert float(want[4]) > 0
    assert abs(float(got[4]) - float(want[4])) <= 1e-4 * float(want[4])


def test_reslot_kernel_bitwise_twin(moving_sim):
    s = moving_sim
    rng = np.random.default_rng(0)
    shift = torch.from_numpy(rng.uniform(-0.01, 0.01, s.xd.shape)
                             .astype(np.float32)).to(s.xd.device)
    live = s.xd < 5e8
    xd = torch.where(live, s.xd + shift, s.xd)
    planes = (xd, s.yd, s.vxd, s.vyd, s.idx_d)
    got = reslot.reslot_cuda(*planes, GRID)
    want = reslot.reslot_torch(*planes, GRID)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_session_on_card_matches_cpu_twins(cuda):
    """The whole slice: 40 steps on the card vs the same Session on the CPU
    (twins), per particle, with identical rebin schedule and counters."""
    def run(device):
        state = bt.init_grid(24, 24, 0.04, device)
        state = state.replace(vx=torch.full((state.n,), 2.0, device=device))
        sess = vs.Session(state, PARAMS, CFG, GRID, device=device)
        sess.run(40)
        return sess
    a, b = run(cuda), run("cpu")
    assert a.sim.rebin_count == b.sim.rebin_count >= 3
    assert (a.overflow, a.readmitted) == (b.overflow, b.readmitted)
    assert torch.equal(a.sim.idx_d.cpu(), b.sim.idx_d)
    sa, sb = a.state(), b.state()
    assert float((sa.x.cpu() - sb.x).abs().max()) <= 1e-5
    assert float((sa.vy.cpu() - sb.vy).abs().max()) <= 1e-4
    assert float(((sa.rho.cpu() - sb.rho) / sb.rho).abs().max()) <= 1e-5


def test_launch_counters_count_kernel_launches(cuda):
    state = bt.init_grid(16, 16, 0.04, cuda)
    sess = vs.Session(state, PARAMS, CFG, GRID, device=cuda)
    before = (cuda_solver.density_cuda.launches,
              cuda_solver.forces_integrate_cuda.launches,
              reslot.reslot_cuda.launches)
    rebins = sess.sim.rebin_count
    sess.run(7)
    assert cuda_solver.density_cuda.launches - before[0] == 7
    assert cuda_solver.forces_integrate_cuda.launches - before[1] == 7
    assert reslot.reslot_cuda.launches - before[2] == \
        sess.sim.rebin_count - rebins
