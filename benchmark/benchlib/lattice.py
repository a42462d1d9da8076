"""The dam break's inputs as a function of (seed, particle id) alone, for
scenes too large to hold in particle order beside the program.

The same upstream ``make_state(n)`` lattice as ``scene.dam_break`` (a side
x side grid at the configuration's spacing, x fastest, at rest), each
position jittered uniformly within +-``jitter``; but the jitter of
particle ``i`` is a counter-based draw, a 32-bit hash of (seed, i, the
coordinate), so any particle's input can be computed again from its id,
in any chunk, on any device.  It agrees with ``scene.dam_break`` in
distribution (uniform jitter on the same lattice), not bit for bit: that
one draws all ``n`` jitters from one ``torch.Generator`` stream.

The hash is murmur3's 32-bit finaliser, run twice with the seed's two
32-bit halves mixed in, in int64 arithmetic that never overflows (a
product is taken 16 bits of the constant at a time), so the CPU and the
card give the same bits.
"""

from __future__ import annotations

import torch

from . import scene

MASK32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 of 32-bit values held in int64, without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def uniform(ids: torch.Tensor, seed: int, lane: int) -> torch.Tensor:
    """float32 draws in [0, 1) (24 bits) for particles ``ids`` (int,
    below 2^30) and coordinate ``lane`` (0: x, 1: y) under ``seed``."""
    s = scene.seed_of(seed)
    h = _fmix32(((ids.to(torch.int64) * 2 + lane) ^ (s & MASK32)) & MASK32)
    h = _fmix32(h ^ (s >> 32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def inputs(sc: dict, seed: int, ids: torch.Tensor) -> tuple:
    """float32 (x, y) of particles ``ids`` (their velocities are zero), on
    the ids' device, with ``scene.dam_break``'s float32 arithmetic."""
    side = int(sc["side"])
    sp = torch.tensor(sc["spacing"], dtype=torch.float32, device=ids.device)
    jit = float(sc["jitter"])
    i = ids.to(torch.int64)
    x = (i % side).to(torch.float32) * sp \
        + (uniform(i, seed, 0) * 2.0 - 1.0) * jit
    y = torch.div(i, side, rounding_mode="floor").to(torch.float32) * sp \
        + (uniform(i, seed, 1) * 2.0 - 1.0) * jit
    return x, y


def generator(sc: dict, seed: int, device):
    """The chunk generator of ``Session.from_generator`` /
    ``init_dense_gen``: global particle indices to that chunk's float32
    (x, y, vx, vy) on ``device``."""
    def gen(gi: torch.Tensor):
        x, y = inputs(sc, seed, gi.to(device))
        z = torch.zeros_like(x)
        return x, y, z, z.clone()
    return gen
