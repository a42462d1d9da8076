"""Shared by the benchmark's tests: the import paths of ``run.py`` (the
benchmark's folder and the checkout) and a small dam break for running a
cell on the CPU through ``harness.run``'s seam."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CHECKOUT = BENCH.parent
for p in (str(CHECKOUT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# 576 particles (24 x 24) in a box tall enough for 14 row blocks, so the
# Session steps on K1 + K2 (below 12 blocks it takes the mono kernel K5)
SMALL = dict(side=24, x_max=1.96, y_max=8.0, warmup_steps=10,
             episode_steps=20, trace_episodes=1)
SMALL_FRAMES = dict(SMALL, frames=2, substeps=8)
SEED = 3_000_000_017


def small(cell: str) -> dict:
    return SMALL_FRAMES if "frames" in cell else SMALL


def argv(cell: str, trace: int = 0, seed: int = SEED) -> list[str]:
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0",
            "--trace", str(trace)]


def seam(cell: str, root=None, **kw) -> dict:
    """``harness.run``'s seam for a small run of ``cell`` on the CPU."""
    import torch

    from benchlib import catalog
    return dict(device=torch.device("cpu"), overrides=small(cell),
                root=root or catalog.ROOT, **kw)


def run_cell(cell: str, trace: int = 0, seed: int = SEED, root=None,
             control=None):
    """(exit code, result) of one small run of ``cell`` on the CPU;
    ``control`` judges that control in the program's place."""
    from benchlib import harness
    return harness.run(harness.parse(argv(cell, trace, seed)),
                       **seam(cell, root, control=control))
