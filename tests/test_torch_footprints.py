"""The default posture's memory budget, with a rebin that collects drops
(F5), on the CPU.

``FOOTPRINTS["default"]`` is the default posture's peak in plane
footprints, measured by ``chip_smoke.py`` phase 14 on an H100, now over a
rebin that collects drops too; ``planar_rebin_default`` switches to the
planar rebin exactly where that many planes stop fitting the card.  The
fused rebin's drop test (``found_in_window``) compares one slot layer of
a window cell at a time; its answer is held here, bit for bit, against the
form that compared all cap layers at once, on planes whose rebin drops
particles.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as tvs
from bevy_gpu_fluid_tpu_torch.ops import reslot

torch.set_num_threads(1)

DEFAULT_BUDGET = 15.375   # plane-footprints (chip_smoke.py phase 14)
H100_BYTES = 85_000_000_000     # an 80 GB card's total, as mem_get_info


def _bench_grid(n):
    """The grid ``tools/bench_scale.py`` builds for n particles."""
    extent = int(np.sqrt(n)) * 0.04
    return tvs.default_grid(0.045, -1.0, extent + 1.0,
                            y_max=extent * 1.1 + 1.0, skin_factor=1.75)


def _plane_bytes(g):
    return 4 * g.ny_pad * g.cap * g.nx_pad


def test_default_budget():
    assert tvs.FOOTPRINTS["default"] == DEFAULT_BUDGET


@pytest.mark.parametrize("n", [96_000_000, 560_000_000, 620_000_000])
def test_planar_rebin_default_threshold_is_the_budget(n):
    g = _bench_grid(n)
    edge = int(DEFAULT_BUDGET * _plane_bytes(g)) + tvs.RESERVE_BYTES
    assert not tvs.planar_rebin_default(g, total_bytes=edge)
    assert tvs.planar_rebin_default(g, total_bytes=edge - 1)


def test_default_posture_on_an_h100_up_to_its_budget():
    """bench_scale's 96M and 560M stay in the default posture on an 80 GB
    card; 620M does not fit it."""
    for n, planar in ((96_000_000, False), (560_000_000, False),
                      (620_000_000, True)):
        assert tvs.planar_rebin_default(
            _bench_grid(n), total_bytes=H100_BYTES) == planar


def _found_dense(pidx_d, idx_d):
    """The drop test comparing all cap slot layers of a window cell at
    once (a [R, cap, cap, C] bool)."""
    R, _, C = pidx_d.shape
    padded = F.pad(idx_d, (1, 1, 0, 0, 1, 1), value=-1)
    found = torch.zeros(pidx_d.shape, dtype=torch.bool)
    for s in range(9):
        win = padded[s // 3:s // 3 + R, :, s % 3:s % 3 + C]
        found |= (pidx_d[:, :, None, :] == win[:, None, :, :]).any(dim=2)
    return found


def test_drop_test_on_a_rebin_that_drops():
    """The live particles of a 3 x 3 block of cells piled into its centre
    cell: the rebin keeps cap of them there and drops the rest, which the
    drop test finds, as the dense form does."""
    grid = tvs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    sess = tvs.Session(bt.init_grid(30, 30, 0.04, "cpu"),
                       bt.FluidParams.demo(),
                       bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5),
                       grid, device="cpu")
    sess.run(3)
    s = sess.sim
    r, c = grid.row0 + 4, 1 + 18
    block = (slice(r - 1, r + 2), slice(None), slice(c - 1, c + 2))
    live = s.xd[block] < 5e8
    k = int(live.sum())
    assert k > grid.cap
    spread = torch.linspace(-0.3, 0.3, k) * float(grid.cell_size)
    s.xd[block][live] = float(grid.origin_x) + (c - 0.5) * float(
        grid.cell_size) + spread
    s.yd[block][live] = float(grid.origin_y) + (r - grid.row0 + 0.5) * float(
        grid.cell_size) + spread.flip(0)
    new = reslot.reslot_torch(s.xd, s.yd, s.vxd, s.vyd, s.idx_d, grid)
    found = tvs.found_in_window(s.idx_d, new[4])
    assert torch.equal(found, _found_dense(s.idx_d, new[4]))
    dropped = (s.idx_d >= 0) & ~found
    assert int(dropped.sum()) == k - grid.cap
    # the Session's rebin collects them: overflow counts them, none lost
    over0, lost0 = sess.sim.overflow, sess.sim.lost
    sess.sim.age = 1 << 30
    sess.run(1)
    assert sess.sim.overflow - over0 == k - grid.cap
    assert sess.sim.lost == lost0
    assert int((sess.sim.sidx >= 0).sum()) + sess.sim.readmitted \
        >= k - grid.cap
