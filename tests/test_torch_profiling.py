"""The port's profiling instruments (utils/profiling.py): ``StepTimer``'s
counts and rates, ``block_until_ready`` over containers, and ``trace``
writing a Chrome trace that names the operators it saw.  Counts are exact;
times are only checked positive (a CPU run measures no device)."""

import json
import os

import torch

import bevy_gpu_fluid_tpu_torch as bt
from bevy_gpu_fluid_tpu_torch.models import verlet_solver as vs
from bevy_gpu_fluid_tpu_torch.utils import profiling


def _session():
    state = bt.init_grid(8, 8, 0.04, "cpu")
    grid = vs.default_grid(0.045, -1.0, 2.5, y_max=3.0)
    return vs.Session(state, bt.FluidParams.demo(),
                      bt.IntegrateConfig.create(x_min=-1.0, x_max=2.5), grid,
                      device="cpu")


def test_step_timer_counts_and_rates():
    sess = _session()
    timer = profiling.StepTimer(sess.n)
    for _ in range(3):
        with timer.measure(2, result=sess.sim):
            sess.run(2)
    with timer.measure(1, result=[sess.sim.xd]):
        sess.run(1)
    assert timer.steps == 7 and sess.sim.step == 7
    assert timer.seconds > 0.0
    assert timer.steps_per_sec == timer.steps / timer.seconds
    assert timer.particle_steps_per_sec == timer.steps_per_sec * 64
    assert timer.summary().startswith("7 steps in ")


def test_block_until_ready_walks_containers():
    t = torch.ones(3)
    nested = {"a": [t, (t, 1)], "b": _session().sim}
    assert profiling.block_until_ready(nested) is nested
    assert profiling._devices(nested) == set()     # CPU tensors: no sync
    assert profiling._devices(t.to("meta")) == set()


def test_trace_writes_a_chrome_trace(tmp_path):
    sess = _session()
    with profiling.trace(str(tmp_path)) as prof:
        sess.run(2)
    path = tmp_path / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert prof.key_averages()
    assert os.path.getsize(path) > 0
