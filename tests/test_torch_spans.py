"""The program's spans (``utils/profiling.span``), counted on the CPU under
``torch.profiler``: a Session's steps, trigger reads, rebins and their
counter reads in every step-loop posture; the slab step's halos, trigger
read, collective rebin, exchange and its two reads; the eager step's
binning and its overflow read; the raster and the frame pump.  With no
profiler running a span is one shared null context; traced and untraced
runs leave the same planes and counters bit for bit, and the spans add no
torch operation (no read, sync or allocation) to the run they mark."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import cuda_solver, grid_solver
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.ops import binning
from bevy_gpu_fluid_tpu_torch.parallel import shard, shard_verlet
from bevy_gpu_fluid_tpu_torch.parallel.mesh import SlabMesh
from bevy_gpu_fluid_tpu_torch.parallel.sharded_session import ShardedSession
from bevy_gpu_fluid_tpu_torch.render import pump, raster
from bevy_gpu_fluid_tpu_torch.utils import profiling

NAMES = {"bgf.step", "bgf.read.trigger", "bgf.rebin", "bgf.rebin.select",
         "bgf.rebin.apply", "bgf.read.rebin_counts", "bgf.read.readmit",
         "bgf.binning", "bgf.read.overflow", "bgf.raster", "bgf.pump.copy",
         "bgf.pump.wait"}
STEPS = 12
# (Session options, lattice spacing, grid capacity): recovery's lattice at
# half the spacing overflows its cells of 2 slots, then spreads, so its
# rebins (every step or two) re-admit spilled particles; the memory
# ceiling's posture (refless trigger, planar rebin, owned planes) on the
# same lattice, so its planar rebins collect and re-admit too
CEILING = {"planar_rebin": True, "refless_trigger": True, "donate": True}
POSTURES = {"default": ({"max_age": 4}, 0.04, 8),
            "planar": ({"max_age": 4, "planar_rebin": True}, 0.04, 8),
            "segmented": ({"max_age": 4, "segmented": True}, 0.04, 8),
            "recovery": ({"max_age": 4}, 0.02, 2),
            "ceiling": ({"max_age": 4, **CEILING}, 0.02, 2)}
PLANAR = ("planar", "ceiling")
SPANNED = (vs, grid_solver, binning, raster, pump)


def _session(posture: str = "default"):
    kw, spacing, cap = POSTURES[posture]
    state = bt.init_grid(8, 8, spacing, "cpu")
    grid = vs.default_grid(0.045, -1.0, 2.5, y_max=1.0, cap=cap)
    return vs.Session(state, bt.FluidParams.demo(),
                      bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5), grid,
                      device="cpu", **kw)


def _traced(fn):
    """(fn's result, [(name, start, end)] of every host event, in ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()]


def _spans(events, name: str) -> list:
    return [(s, e) for n, s, e in events if n == name]


def _inside(inner, outer) -> bool:
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e in inner)


def _trigger_reads(sess, max_age: int) -> list:
    """Whether each call of ``sess``'s trigger from here on reads: a state
    younger than ``max_age`` (an older one rebins without a read)."""
    need, calls = sess._need, []

    def counted(sim):
        calls.append(sim.age < max_age)
        return need(sim)

    sess._need = counted
    return calls


@pytest.mark.parametrize("posture", list(POSTURES))
def test_session_spans_count_steps_reads_and_rebins(posture):
    sess = _session(posture)
    max_age = POSTURES[posture][0]["max_age"]
    before = sess.sim.rebin_count
    readmitted = sess.sim.readmitted
    ages = []
    reads = _trigger_reads(sess, max_age)

    def run():
        for _ in range(STEPS):
            ages.append(sess.sim.age)
            sess.run(1)

    _, ev = _traced(run)
    rebins = sess.sim.rebin_count - before
    assert rebins >= 2
    assert {n for n, *_ in ev if n.startswith("bgf.")} <= NAMES
    assert len(_spans(ev, "bgf.step")) == STEPS
    assert len(_spans(ev, "bgf.read.trigger")) == sum(reads)
    assert len(_spans(ev, "bgf.rebin")) == rebins
    assert len(_spans(ev, "bgf.read.rebin_counts")) == rebins
    assert _inside(_spans(ev, "bgf.read.rebin_counts"),
                   _spans(ev, "bgf.rebin"))
    readmits = _spans(ev, "bgf.read.readmit")
    assert _inside(readmits, _spans(ev, "bgf.rebin"))
    if posture in ("recovery", "ceiling"):
        assert sess.sim.readmitted > readmitted and readmits
    # the planar rebin's two phases, once a rebin each, inside it and one
    # after the other; the counter read in the routing phase
    select = _spans(ev, "bgf.rebin.select")
    apply = _spans(ev, "bgf.rebin.apply")
    assert len(select) == len(apply) == (rebins if posture in PLANAR else 0)
    assert _inside(select, _spans(ev, "bgf.rebin"))
    assert _inside(apply, _spans(ev, "bgf.rebin"))
    if posture in PLANAR:
        assert _inside(_spans(ev, "bgf.read.rebin_counts"), select)
        assert all(s[1] <= a[0] for s, a in zip(sorted(select),
                                                sorted(apply)))
    if posture != "segmented":
        # the step's check reads once unless the bins aged out
        assert sum(reads) == sum(a < max_age for a in ages)
        assert _inside(_spans(ev, "bgf.rebin"), _spans(ev, "bgf.step"))


def _read_spans(ev) -> list:
    return [(s, e) for n, s, e in ev if n.startswith("bgf.read.")]


@pytest.mark.parametrize("posture", ["default", "planar", "recovery",
                                     "ceiling"])
def test_every_read_lies_inside_a_step(posture):
    sess = _session(posture)
    _, ev = _traced(lambda: sess.run(STEPS))
    assert len(_read_spans(ev)) >= STEPS // 2
    assert _inside(_read_spans(ev), _spans(ev, "bgf.step"))


def _eager_inputs():
    state = bt.init_grid(8, 8, 0.04, "cpu")
    grid = grid_solver.default_grid(0.045, -1.0, 2.5, y_max=1.0)
    return (state, bt.FluidParams.demo(),
            bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5), grid)


def test_eager_steps_bin_and_read_overflow_once_each():
    state, params, cfg, grid = _eager_inputs()
    n = 3
    _, ev = _traced(lambda: cuda_solver.multi_step(state, params, cfg, grid,
                                                   n))
    assert {n for n, *_ in ev if n.startswith("bgf.")} == {
        "bgf.step", "bgf.binning", "bgf.read.overflow"}
    for name in ("bgf.step", "bgf.binning", "bgf.read.overflow"):
        assert len(_spans(ev, name)) == n, name
    assert _inside(_spans(ev, "bgf.read.overflow"),
                   _spans(ev, "bgf.binning"))
    assert _inside(_spans(ev, "bgf.binning"), _spans(ev, "bgf.step"))


def test_frame_and_pump_spans():
    sess = _session()
    fp = pump.FramePump(pull=True)

    def frames():
        img = sess.frame()
        return fp.push(img), fp.push(img), fp.flush()

    (first, second, last), ev = _traced(frames)
    g = sess.grid
    assert first is None
    assert second.shape == last.shape == (g.ny * 2, g.nx * 2, 3)
    assert len(_spans(ev, "bgf.raster")) == 1
    assert len(_spans(ev, "bgf.pump.copy")) == 2
    assert len(_spans(ev, "bgf.pump.wait")) == 2


def test_span_is_one_null_context_unless_profiled():
    off = profiling.span("bgf.step")
    assert off is profiling.span("bgf.rebin")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("bgf.step")
        assert on is not off
        with on:
            pass
    assert profiling.span("bgf.step") is off


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    return a == b


def _outputs(posture: str) -> dict:
    """A short run's every plane and counter: a Session's DenseSim, or the
    eager solver's state and overflow."""
    if posture == "eager":
        state, diag = cuda_solver.multi_step(*_eager_inputs(), 2)
        return {"overflow": diag.overflow,
                **{f: getattr(state, f) for f in ("x", "y", "vx", "vy",
                                                  "rho", "p")}}
    sess = _session(posture)
    sess.run(STEPS)
    return {f: getattr(sess.sim, f) for f in vs.DenseSim.__dataclass_fields__}


@pytest.mark.parametrize("posture", ["default", "planar", "recovery",
                                     "ceiling", "eager"])
def test_traced_and_untraced_runs_are_bitwise_equal(posture):
    plain = _outputs(posture)
    traced, _ = _traced(lambda: _outputs(posture))
    for f, v in plain.items():
        assert _same(v, traced[f]), f


def test_spans_add_no_torch_operation(monkeypatch):
    """The same run traced with and without the spans records the same
    torch operations, each as many times."""

    def ops(ev):
        return collections.Counter(n for n, *_ in ev
                                   if not n.startswith("bgf."))

    def work():
        for posture in ("recovery", "ceiling"):
            sess = _session(posture)
            sess.run(STEPS)
        fp = pump.FramePump(pull=True)
        fp.push(sess.frame())
        fp.flush()
        state, params, cfg, grid = _eager_inputs()
        cuda_solver.multi_step(state, params, cfg, grid, 2)

    work()                      # any one-time set-up outside both traces
    _, spanned = _traced(work)
    for mod in SPANNED:
        monkeypatch.setattr(mod, "span", lambda name: contextlib.nullcontext())
    _, bare = _traced(work)
    assert {n for n, *_ in spanned if n.startswith("bgf.")} == NAMES
    assert not [n for n, *_ in bare if n.startswith("bgf.")]
    assert ops(spanned) == ops(bare)


# The slab step: a lattice across both slabs of a two-slab CPU mesh (the
# boundary at x = 0.81125, a lattice column 6.25 mm left of it), kicked
# right, so that its collective rebins (the bins age out every 4 steps)
# carry particles across the boundary
SLAB_NAMES = {"bgf.step", "bgf.read.trigger", "bgf.halo", "bgf.rebin",
              "bgf.rebin.exchange", "bgf.read.rebin_counts", "bgf.read.live"}
SLAB_MAX_AGE = 4


def _slab_session():
    state = bt.init_grid(40, 6, 0.04, "cpu")
    state = state.replace(x=state.x - 0.475,
                          vx=torch.full_like(state.x, 3.0))
    spec = shard.ShardSpec.build(h=0.045 * 1.75, x_min=-1.0, x_max=2.5,
                                 y_max=1.0, n_devices=2, capacity=1024)
    return ShardedSession(state, bt.FluidParams.demo(),
                          bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5),
                          spec, SlabMesh(["cpu"] * 2), max_age=SLAB_MAX_AGE)


def test_slab_spans_count_halos_reads_rebins_and_exchanges():
    sess = _slab_session()
    alive = sess.alive
    before = sess.rebin_count
    ages = []

    def run():
        for _ in range(STEPS):
            ages.append(sess.sim.age)
            sess.run(1)

    _, ev = _traced(run)
    rebins = sess.rebin_count - before
    assert rebins >= 2 and sess.alive != alive
    assert {n for n, *_ in ev if n.startswith("bgf.")} == SLAB_NAMES
    assert len(_spans(ev, "bgf.step")) == STEPS
    # the four planes' halo, then rho's, every step
    assert len(_spans(ev, "bgf.halo")) == 2 * STEPS
    assert _inside(_spans(ev, "bgf.halo"), _spans(ev, "bgf.step"))
    # the trigger reads once a step unless the bins aged out
    assert len(_spans(ev, "bgf.read.trigger")) == sum(
        a < SLAB_MAX_AGE for a in ages)
    assert _inside(_spans(ev, "bgf.rebin"), _spans(ev, "bgf.step"))
    for name in ("bgf.rebin", "bgf.rebin.exchange", "bgf.read.rebin_counts",
                 "bgf.read.live"):
        assert len(_spans(ev, name)) == rebins, name
        assert _inside(_spans(ev, name), _spans(ev, "bgf.rebin")), name
    assert _inside(_read_spans(ev), _spans(ev, "bgf.step"))


def _slab_outputs() -> dict:
    sess = _slab_session()
    sess.run(STEPS)
    return {f: getattr(sess.sim, f)
            for f in sess.sim.__dataclass_fields__}


def test_slab_traced_and_untraced_runs_are_bitwise_equal():
    plain = _slab_outputs()
    traced, _ = _traced(_slab_outputs)
    for f, v in plain.items():
        if isinstance(v, list):
            assert len(v) == len(traced[f]), f
            assert all(_same(a, b) for a, b in zip(v, traced[f])), f
        else:
            assert _same(v, traced[f]), f


def test_slab_spans_add_no_torch_operation(monkeypatch):
    def ops(ev):
        return collections.Counter(n for n, *_ in ev
                                   if not n.startswith("bgf."))

    _slab_outputs()
    _, spanned = _traced(_slab_outputs)
    for mod in (vs, shard_verlet):
        monkeypatch.setattr(mod, "span", lambda name: contextlib.nullcontext())
    _, bare = _traced(_slab_outputs)
    assert {n for n, *_ in spanned if n.startswith("bgf.")} == SLAB_NAMES
    assert not [n for n, *_ in bare if n.startswith("bgf.")]
    assert ops(spanned) == ops(bare)
