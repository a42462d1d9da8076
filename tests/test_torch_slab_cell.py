"""The benchmark's slab cell (``dam1m-slabs2``: the dam break in two x-slabs
through ``ShardedSession``) on a small dam break on the CPU, through the
cell's own driver and ``harness.run``'s seam, in a process of its own (this
suite loads JAX, which a run refuses to have loaded): the run is correct;
the benchmark's own reading of the slabs (``benchlib/slabs.view``) gives
the particles that the program's ``shard_verlet.extract_fluid_state``
gives; the checked rebin carried particles across the slab boundary; the
slab step's kernel shares count a launch a slab; the bfloat16 controls
fail the cell's limits, and so does a rebin that drops the particles it
exchanges.  On the card, the cell's own run at 1M."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parent.parent
BENCH = CHECKOUT / "benchmark"
CELL = "dam1m-slabs2"
SEED = 3_000_000_019
# 576 particles (24 x 24); the box's walls put the slab boundary 0.1 mm
# right of the block's right face (x_min - 2 cells + 15 cells of 0.07875 =
# 0.9205), so the face's first outward steps carry particles into slab 1
# before the bins age out at step 8, the untimed episode's rebin (steps
# 4-16)
SCENE = dict(side=24, x_min=-0.10325, x_max=1.9, y_max=2.056, max_age=8,
             warmup_steps=4, episode_steps=12, trace_episodes=1)

SCRIPT = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
import control
from benchlib import catalog, harness, slabs
from bevy_gpu_fluid_tpu_torch.parallel import shard_verlet
cell, seed, ovr = sys.argv[3], int(sys.argv[4]), json.loads(sys.argv[5])
dev = torch.device("cpu")
argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0",
        "--trace", "0"]
out = {}
rc, r = harness.run(harness.parse(argv), device=dev, overrides=ovr)
out["run"] = dict(rc=rc, **r)

ctx = harness.Ctx(catalog.cell(cell), seed, dev, False, ovr)
st = slabs.build(ctx, ovr["episode_steps"])
sess, spec, n = st["sess"], st["spec"], st["n"]
views = {}
for name, sim in (("snapshot", st["snap"]), ("episode", sess.sim)):
    v = views[name] = slabs.view(sim, spec, n)
    fs = shard_verlet.extract_fluid_state(sim, spec, sess.params, n)
    a = v["active"]
    out[name] = dict(
        seen_once=bool((v["seen"] == 1).all()),
        same=all(torch.equal(v[k], getattr(fs, k)) for k in
                 ("x", "y", "vx", "vy")) and torch.equal(v["rho"][a],
                                                         fs.rho[a]),
        slab_faults=slabs.slab_faults(sim, spec, v))
out["crossed"] = int((views["episode"]["slab"]
                      != views["snapshot"]["slab"]).sum())
out["counts"] = st["episode"]

# the slab step's kernel shares on a trace of 8 launches of 0.2 ms: the
# whole state's least time over a step's two launches, one a slab
import types
import roofline
from benchlib import readers, slab_readers
trace = types.SimpleNamespace(kernel=lambda pattern: (8, 2e-4))
fake = dict(trace=trace, end_to_end=("particle_steps_per_s",),
            scene={"slabs": 2}, samples=lambda: [(1000, 30000)])
out["shares"] = {
    k: [slab_readers.kernel_share(types.SimpleNamespace(**fake), k),
        100 * readers.KERNELS[k][1](1000, 30000).least_s / (2 * 2e-4)]
    for k in ("k1", "k2")}
out["shares_none"] = [
    slab_readers.kernel_share(types.SimpleNamespace(**dict(fake, **kw)), "k2")
    for kw in ({"trace": None}, {"scene": {}}, {"end_to_end": ()})]

got = control.readings(cell, seed, dev, ovr)
out["controls"] = {side: v["correct"] for side, v in got.items()}

def no_merge(planes, lane, src, base_cnt, cap):
    return torch.zeros(src[0].shape, dtype=torch.bool, device=src[0].device)
shard_verlet.merge_col = no_merge
rc, r = harness.run(harness.parse(argv), device=dev, overrides=ovr)
out["no_merge"] = dict(rc=rc, **r)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(BENCH), str(CHECKOUT), CELL,
         str(SEED), json.dumps(SCENE)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_the_cell_is_correct_on_the_cpu(runs):
    r = runs["run"]
    assert r["rc"] == 0
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["start"]["value"] == 0
    assert r["checks"]["structure"]["value"] == 0
    assert set(r["metrics"]) == {"particle_steps_per_s", "setup_s"}


def test_the_slab_reading_is_the_programs_extraction(runs):
    for name in ("snapshot", "episode"):
        assert runs[name] == {"seen_once": True, "same": True,
                              "slab_faults": 0}, name


def test_the_checked_rebin_carries_particles_across_the_boundary(runs):
    rebins, lost = runs["counts"][:2]
    assert rebins >= 1 and lost == 0
    assert runs["crossed"] > 0


def test_the_slab_kernel_shares_count_one_launch_a_slab(runs):
    for k, (got, want) in runs["shares"].items():
        assert got == pytest.approx(want, rel=1e-12), k
    assert runs["shares_none"] == [None, None, None]


def test_the_controls_fail_the_cell(runs):
    assert runs["controls"] == {"program": True, "bfloat16": False,
                                "bfloat16_pairs": False}


def test_a_rebin_that_drops_its_exchange_is_not_correct(runs):
    r = runs["no_merge"]
    assert r["rc"] == 0
    assert not r["correct"]
    assert r["checks"]["structure"]["value"] > 0


@pytest.mark.cuda
def test_the_cell_on_the_card():
    """The benchmark's run of the cell at 1M on the card: 300 warm-up steps,
    the untimed episode and one timed 600-step episode, lost 0, every
    field finite, the first binning's and the checked steps' bookkeeping
    exact."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["start"]["value"] == 0
    assert r["checks"]["structure"]["value"] == 0
    assert r["device"]["platform"] == "gpu"
