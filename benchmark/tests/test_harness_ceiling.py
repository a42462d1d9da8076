"""The memory-ceiling cell (``ceiling779m-step``) at a CPU size, in the
posture its configuration records: the run through ``harness.run``'s seam
is correct and the controls and broken timed paths are not; the judge's
bands give the numbers of the unbanded judge; the counter-based inputs do
not depend on how they are chunked; the cell's own readers."""

import dataclasses
import types

import harness_support as hs
import numpy as np
import pytest
import torch

import roofline
import roofline_ceiling
from benchlib import (bands, catalog, ceiling_readers, checks, dense,
                      lattice, refless, scene)

CELL = "ceiling779m-step"
# the harness's small dam break, with a window of four 10-step segments
SMALL = dict(hs.SMALL, window_steps=40, segment_steps=10)
SC = {**catalog.cell(CELL)["config"], **hs.SMALL}


def _run(control=None, seed=hs.SEED):
    from benchlib import harness
    return harness.run(harness.parse(hs.argv(CELL, seed=seed)),
                       device=torch.device("cpu"), overrides=SMALL,
                       control=control)


def test_the_cell_runs_correct_in_the_recorded_posture(capsys):
    rc, r = _run()
    assert rc == 0
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 and r["failed"] == 0
    assert set(r["metrics"]) == {"particle_steps_per_s.large", "setup_s"}
    err = capsys.readouterr().err
    assert "'planar_rebin': 1, 'refless_trigger': 1, 'donate': 1" in err
    assert "(plain, program)" in err and "(rebin, program)" in err


def test_both_controls_fail_it():
    import control
    got = control.readings(CELL, hs.SEED, torch.device("cpu"), SMALL)
    limits = catalog.load("workloads", CELL)["limits"]
    assert got["program"]["correct"]
    for name in checks.CONTROLS:
        assert not got[name]["correct"], name
        assert any(got[name][k] > v for k, v in limits.items()), name


def _break(monkeypatch, what: str) -> None:
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    from bevy_gpu_fluid_tpu_torch.ops import reslot
    if what == "no_sum":
        parts = vs.make_step_parts

        def forgetful_parts(*a, **kw):
            pure, rebin, need = parts(*a, **kw)

            def pure_step(sim):   # each step's move, not their sum
                return pure(dataclasses.replace(
                    sim, disp2=torch.zeros_like(sim.disp2)))
            return pure_step, rebin, need
        monkeypatch.setattr(vs, "make_step_parts", forgetful_parts)
    elif what == "skip_k7":
        apply = reslot.apply_planes

        def skipping(planes, code, occ, grid):
            vx = planes[2]
            out = apply(planes, code, occ, grid)
            out[2] = vx           # the vx plane left where it was
            return out
        monkeypatch.setattr(reslot, "apply_planes", skipping)
    else:
        gen = lattice.generator
        monkeypatch.setattr(lattice, "generator",
                            lambda sc, seed, device: gen(sc, 0, device))


@pytest.mark.parametrize("fault", ["no_sum", "skip_k7", "seed_ignored"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    _break(monkeypatch, fault)
    rc, r = _run()
    assert rc == 0
    assert not r["correct"], r["checks"]


# ---- the judge's bands against the unbanded judge ----

def _session(spacing=0.04, cap=8, side=12):
    """A ceiling-posture Session on the seeded lattice (``spacing`` and
    ``cap`` of 0.02 and 2 overflow its cells, so its rebins park and
    re-admit particles)."""
    import bevy_gpu_fluid_tpu_torch as bt
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    sc = dict(SC, side=side, spacing=spacing, cap=cap, x_max=1.48,
              y_max=1.5)
    params = bt.FluidParams.create(sc["h"], sc["rho_0"], sc["k"], sc["mu"],
                                   sc["m"])
    cfg = bt.IntegrateConfig.create(dt=sc["dt"], x_min=sc["x_min"],
                                    x_max=sc["x_max"], bounce=sc["bounce"],
                                    floor_y=sc["floor_y"])
    grid = vs.default_grid(sc["h"], sc["x_min"], sc["x_max"],
                           y_max=sc["y_max"], cap=cap, skin_factor=sc["skin"])
    sess = vs.Session.from_generator(
        lattice.generator(sc, hs.SEED, "cpu"), side * side, params, cfg,
        grid, device="cpu", planar_rebin=True, refless_trigger=True,
        donate=True, segmented=False)
    return sess, sc, grid


def _copy(sim):
    return dataclasses.replace(sim, **{
        f.name: getattr(sim, f.name).clone()
        for f in dataclasses.fields(sim)
        if isinstance(getattr(sim, f.name), torch.Tensor)})


def _inputs(sc, n):
    x, y = lattice.inputs(sc, hs.SEED, torch.arange(n))
    return dict(x=x, y=y, vx=torch.zeros(n), vy=torch.zeros(n))


def _spoil(sim, grid):
    """A first binning with faults of every kind: a value off, a particle
    twice (both copies alike, so the particle-order view reads the same
    whichever it takes), a particle missing below a live slot, a particle
    in another cell."""
    sim = _copy(sim)
    planes = [sim.xd, sim.yd, sim.vxd, sim.vyd, sim.idx_d]
    on = sim.idx_d >= 0
    count = on.sum(dim=1)
    live = torch.nonzero(on.reshape(-1)).reshape(-1)
    sim.xd.view(-1)[int(live[0])] += 1e-3
    sim.xd.view(-1)[int(live[14])] += 3 * grid.cell_size
    r, col = (int(v) for v in torch.nonzero((count >= 1)
                                            & (count < grid.cap))[3])
    for p in planes:
        p[r, int(count[r, col]), col] = p[r, 0, col]
    r, col = (int(v) for v in torch.nonzero(count >= 2)[-1])
    sim.idx_d[r, 0, col] = -1
    return sim


@pytest.mark.parametrize("spoiled", [False, True])
def test_banded_start_is_the_unbanded_start(spoiled):
    sess, sc, grid = _session()
    sim = _spoil(sess.sim, grid) if spoiled else sess.sim
    n = sess.n
    want = checks.start_faults(dense.view(sim, grid, n), _inputs(sc, n), sc)
    assert (want > 3) == spoiled
    for rows in (1, 3, grid.ny_pad):
        assert bands.start_faults(sim, grid, sc, hs.SEED, n, rows) == want


def _pairs(sess, kinds=("plain", "rebin"), limit=80):
    """(pre copy, pre held, post) of the first step of each kind."""
    out = {}
    for _ in range(limit):
        pre = _copy(sess.sim)
        held = bands.hold(sess.sim)
        before = sess.sim.rebin_count
        sess.run(1)
        kind = "rebin" if sess.sim.rebin_count != before else "plain"
        if kind in kinds and kind not in out:
            out[kind] = (pre, held, _copy(sess.sim))
        if len(out) == len(kinds):
            return out
    raise AssertionError(f"no step of each kind in {limit}: {list(out)}")


@pytest.mark.parametrize("scene_kind", ["lattice", "overflowing"])
def test_banded_steps_are_the_unbanded_steps(scene_kind):
    sess, sc, grid = (_session() if scene_kind == "lattice"
                      else _session(0.02, 2))
    sess.run(20)
    kinds = ("plain", "rebin")
    if scene_kind == "overflowing":   # it rebins every step, parking some
        kinds = ("rebin",)
        assert sess.sim.overflow > 0 and sess.sim.suspended > 0
    for kind, (pre, held, post) in _pairs(sess, kinds).items():
        n = sess.n
        whole = checks.step_numbers(dense.view(pre, grid, n),
                                    dense.view(post, grid, n), sc)
        got = {rows: bands.step_numbers(held, bands.view(post), grid, sc, n,
                                        (None, "bfloat16"), rows)
               for rows in (1, 2, 5, grid.ny_pad)}
        for rows, nums in got.items():
            assert nums[None]["structure"] == 0, (kind, rows)
            assert nums == {c: {**v, **{
                k: pytest.approx(v[k], rel=1e-12, abs=1e-15)
                for k in ("rho_rel", "vel_abs", "pos_abs")}}
                for c, v in got[grid.ny_pad].items()}, (kind, rows)
            for k in ("rho_rel", "vel_abs", "pos_abs"):
                assert nums[None][k] == pytest.approx(whole[k], rel=1e-12,
                                                      abs=1e-15), (kind, k)
            assert nums["bfloat16"]["rho_rel"] > 1e-3


def test_a_step_that_breaks_a_refless_rule_is_counted():
    sess, sc, grid = _session()
    sess.run(10)
    pairs = _pairs(sess)
    _, held, post = pairs["plain"]
    n = sess.n

    def faults(pre, post):
        return bands.step_numbers(pre, bands.view(post), grid, sc, n,
                                  rows=3)[None]["structure"]

    assert faults(held, post) == 0
    # the sum: disp2 after the step not its given value plus the move
    assert faults(held, dataclasses.replace(post, disp2=post.disp2 * 2)) == 1
    # the trigger: a plain step given a disp2 past half the skin
    over = dataclasses.replace(held, disp2=held.disp2 * 0 + 1.0)
    assert faults(over, post) >= 1
    # the bound: a particle farther from its cell than disp2 allows
    moved = _copy(post)
    live = torch.nonzero(moved.idx_d.reshape(-1) >= 0).reshape(-1)
    moved.xd.view(-1)[int(live[3])] += 2 * grid.cell_size
    assert faults(held, moved) >= 1
    # the counters
    assert faults(held, dataclasses.replace(post, step=post.step + 1)) == 1


def test_the_refless_rules_by_hand():
    sc = dict(SC)
    half = checks.skin_half(sc)
    assert refless.trigger_fault(half * 1.01, 3, True, sc) == 0
    assert refless.trigger_fault(half * 1.01, 3, False, sc) == 1
    assert refless.trigger_fault(half * 0.99, 3, True, sc) == 1
    assert refless.trigger_fault(half, 3, True, sc) == 0      # within TOL
    assert refless.trigger_fault(0.0, sc["max_age"], False, sc) == 1
    d = torch.tensor(0.01, dtype=torch.float32)
    m = torch.tensor(4e-6, dtype=torch.float32)
    want = refless.summed(d, False, m)
    root = np.sqrt(np.float32(4e-6))
    assert float(want) == float(np.float32(0.01) + root)
    assert float(refless.summed(d, True, m)) == float(root)
    assert refless.sum_fault(want, want) == 0
    assert refless.sum_fault(want * (1 + 1e-6), want) == 1
    x = torch.tensor([0.5, 0.5], dtype=torch.float32)
    assert float(refless.move2(x, x, x + 3e-3, x - 4e-3)) == \
        pytest.approx(25e-6, rel=1e-4)


# ---- the inputs ----

def test_inputs_are_a_function_of_seed_and_id():
    sc = dict(SC, side=100)
    n = 100 * 100
    ids = torch.arange(n)
    x, y = lattice.inputs(sc, 2**31 + 5, ids)
    gen = lattice.generator(sc, 2**31 + 5, "cpu")
    for chunk in (1, 7, 1000, n):
        parts = [gen(ids[lo:lo + chunk]) for lo in range(0, n, chunk)]
        assert torch.equal(torch.cat([p[0] for p in parts]), x)
        assert torch.equal(torch.cat([p[1] for p in parts]), y)
        assert not any(bool(p[2].any() or p[3].any()) for p in parts)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    assert torch.equal(lattice.inputs(sc, 2**31 + 5, perm)[0], x[perm])
    other = lattice.inputs(sc, 2**31 + 6, ids)[0]
    high = lattice.inputs(sc, 2**31 + 5 + 2**40, ids)[0]
    assert not torch.equal(other, x) and not torch.equal(high, x)


def test_inputs_agree_with_the_dam_break_in_distribution():
    sc = dict(SC, side=200)
    n = 200 * 200
    x, y = lattice.inputs(sc, hs.SEED, torch.arange(n))
    ref = scene.dam_break(sc, hs.SEED, "cpu")
    lat_x = (torch.arange(n) % 200).float() * torch.tensor(0.04)
    lat_y = torch.div(torch.arange(n), 200, rounding_mode="floor").float() \
        * torch.tensor(0.04)
    jit = float(sc["jitter"])
    for got, want, lat in ((x, ref["x"], lat_x), (y, ref["y"], lat_y)):
        a, b = (got - lat).double() / jit, (want - lat).double() / jit
        assert float(a.abs().max()) <= 1.01
        q = torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9], dtype=torch.float64)
        assert torch.allclose(torch.quantile(a, q), torch.quantile(b, q),
                              atol=0.03)
        assert abs(float(a.mean())) < 0.02 and abs(float(b.mean())) < 0.02


def test_the_hash_is_murmurs_finaliser():
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    seed = 2**33 + 12345
    ids = [0, 1, 2**20 + 3, 779303055]
    s = scene.seed_of(seed)
    for lane in (0, 1):
        want = [(fmix(fmix(((i * 2 + lane) ^ (s & 0xFFFFFFFF)) & 0xFFFFFFFF)
                      ^ (s >> 32)) >> 8) / 2**24 for i in ids]
        got = lattice.uniform(torch.tensor(ids), seed, lane).tolist()
        assert got == want


def test_chunked_inits_are_bitwise_the_same():
    from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
    sess, sc, grid = _session()
    gen = lattice.generator(sc, hs.SEED, "cpu")
    a = vs.init_dense_gen(gen, sess.n, grid, 1, device="cpu")
    b = vs.init_dense_gen(gen, sess.n, grid, 7, device="cpu")
    for f in ("xd", "yd", "vxd", "vyd", "idx_d", "sidx"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- the cell's readers ----

def _ctx(window, trace=None, positions=()):
    ctx = types.SimpleNamespace(trace=trace, window=window,
                                end_to_end=("particle_steps_per_s.large",),
                                positions=list(positions))
    ctx.samples = lambda: [(x.numel(), roofline.pairs_within(x, y, 0.045))
                           for x, y in ctx.positions]
    return ctx


class _Trace:
    """A trace's reduced events: host spans, device operations."""

    def __init__(self, cpu, ops):
        self.cpu, self.ops = cpu, ops

    def kernel(self, pattern):
        import re
        d = [e - s for name, s, e, _ in self.ops if re.search(pattern, name)]
        return len(d), (sum(d) / len(d) * 1e-9 if d else 0.0)


CEILING = dict(planar_rebin=1, refless_trigger=1, donate=1, segmented=0)
OPS = [("void (anonymous namespace)::forces_integrate_kernel<true>(float "
        "const*)", 0, 2_000_000, 5),
       ("void (anonymous namespace)::forces_integrate_kernel<false>(float "
        "const*)", 0, 9_000_000, 5),
       ("void (anonymous namespace)::select_kernel<int>(float const*)",
        10_000_000, 10_500_000, 10_000_001),
       ("(anonymous namespace)::apply_code_kernel(unsigned int const*)",
        11_000_000, 11_200_000, 10_000_002),
       ("void at::native::reduce_kernel", 12_000_000, 12_100_000, 30_000_000)]
SPANS = [("bgf.rebin", 10_000_000, 10_000_500, 0, 1),
         ("bgf.step", 0, 20_000_000, 0, 1)]


def test_the_readers_read_only_the_ceiling_posture():
    x = torch.arange(64, dtype=torch.float32) % 8 * 0.04
    y = torch.div(torch.arange(64), 8, rounding_mode="floor").float() * 0.04
    trace = _Trace(SPANS, OPS)
    ctx = _ctx(CEILING, trace, [(x, y)])
    pairs = roofline.pairs_within(x, y, 0.045)
    want = roofline.k2(64, pairs)
    k2r = roofline_ceiling.k2r(64, pairs)
    assert k2r.bytes == 9 * 4 * 64 and k2r.ops == want.ops
    assert ceiling_readers.kernel_share(ctx, "k2r") == pytest.approx(
        100 * k2r.least_s / 2e-3)
    assert ceiling_readers.kernel_share(ctx, "k6") == pytest.approx(
        100 * 12 * 64 / roofline.HBM_BYTES_PER_S / 0.5e-3)
    assert ceiling_readers.kernel_share(ctx, "k7") == pytest.approx(
        100 * 12 * 64 / roofline.HBM_BYTES_PER_S / 0.2e-3)
    assert ceiling_readers.rebin_device_ms(ctx) is None     # not traced
    assert ceiling_readers.rebin_device_ms(
        _ctx(dict(CEILING, rebin_device_ms=0.7), trace)) == 0.7
    for window in ({}, dict(CEILING, refless_trigger=0),
                   dict(CEILING, planar_rebin=0)):
        other = _ctx(dict(window, rebin_device_ms=0.7), trace, [(x, y)])
        assert ceiling_readers.kernel_share(other, "k2r") is None
        assert ceiling_readers.rebin_device_ms(other) is None
    assert ceiling_readers.kernel_share(_ctx(CEILING, _Trace(SPANS, [])),
                                        "k6") is None


class _Event:
    """A raw profiler event, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, dur, corr, cpu=True):
        self._v = (name, start, dur, corr, cpu)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[4]
                else torch.autograd.DeviceType.CUDA)

    def activity_type(self):
        return "cpu_op" if self._v[4] else "kernel"


def test_rebin_device_time_matches_launches_by_the_runtime_ids():
    """Each device operation is put where the runtime call that launched
    it was, by the runtime's correlation id: a CPU operator with the same
    id (inside a rebin span) does not pull K2 into the rebin."""
    trace = _Trace(SPANS + [("bgf.rebin", 50_000_000, 50_000_400, 0, 1)],
                   [])
    events = [
        _Event("cudaLaunchKernel", 10_000_100, 10, 7),      # K6, in rebin 1
        _Event("cudaLaunchKernel", 10_000_200, 10, 8),      # K7, in rebin 1
        _Event("cudaLaunchKernel", 12_000_000, 10, 9),      # K2, after it
        _Event("aten::empty", 10_000_300, 10, 9),           # a colliding id
        _Event("cudaMemcpyAsync", 50_000_100, 10, 11),      # rebin 2
        _Event("select_kernel<int>", 10_000_500, 500_000, 7, cpu=False),
        _Event("apply_code_kernel<int>", 10_600_000, 200_000, 8, cpu=False),
        _Event("forces_integrate_kernel<true>", 12_000_100, 4_000_000, 9,
               cpu=False),
        _Event("Memcpy DtoH", 50_000_200, 300_000, 11, cpu=False),
        _Event("bench.traced", 0, 99_000_000, 0, cpu=False)]
    # (0.5 + 0.2 + 0.3) ms over the two rebins
    assert ceiling_readers.launched_in(events, trace) == pytest.approx(0.5)
    assert ceiling_readers.launched_in(events[:5], trace) is None
    assert ceiling_readers.launched_in(events, _Trace(SPANS[1:], [])) is None
