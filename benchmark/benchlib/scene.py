"""The dam break's inputs from the seed: the upstream ``make_state(n)``
lattice (examples/bench_gpu.rs:21-26, a side x side grid at the
configuration's spacing, at rest), each position jittered uniformly within
+-``jitter``.  Made on the device by one generator call, so the same seed
gives the same inputs, and handed alike to the program and the reference."""

from __future__ import annotations

import torch


def seed_of(seed: int) -> int:
    """The generator's seed: any whole number, folded into 64 bits."""
    return int(seed) % (1 << 64)


def dam_break(sc: dict, seed: int, device) -> dict:
    """float32 x, y, vx, vy [n] in particle order (x fastest)."""
    side = int(sc["side"])
    n = side * side
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    u = torch.rand((2, n), generator=gen, device=device)
    i = torch.arange(n, device=device)
    sp = torch.tensor(sc["spacing"], dtype=torch.float32, device=device)
    jit = float(sc["jitter"])
    x = (i % side).to(torch.float32) * sp + (u[0] * 2.0 - 1.0) * jit
    y = torch.div(i, side, rounding_mode="floor").to(torch.float32) * sp \
        + (u[1] * 2.0 - 1.0) * jit
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return dict(x=x, y=y, vx=z, vy=z.clone())
