"""The least time of the memory-ceiling posture's own launches, counted as
``roofline`` counts (frozen bytes a live particle, float32 operations a
pair closer than h), whatever layout implements them:

- K2's refless instance (``kRefless = true``): x, y, vx, vy and rho in,
  x, y, vx and vy out, 9 floats a live particle (no rebin reference
  planes to read); its operations those of ``roofline.k2``.
- K6, the planar rebin's routing pass: x and y in, an int32 routing code
  out, 12 bytes a live particle.
- K7, one payload plane routed through the code: the value and its code
  in, the routed value out, 12 bytes a live particle a launch (five
  launches a rebin).

K6 and K7 are counted by their bytes alone (their comparisons and index
arithmetic are a few integer operations a slot).
"""

from __future__ import annotations

from roofline import F32, Work, k2

K2R_BYTES = 9 * F32
K6_BYTES = 3 * F32
K7_BYTES = 3 * F32


def k2r(n: int, pairs: int) -> Work:
    """K2 refless: 9 floats a live particle, ``roofline.k2``'s operations."""
    return Work(K2R_BYTES * n, k2(n, pairs).ops)


def k6(n: int, pairs: int) -> Work:
    """K6: x, y in, a routing code out."""
    return Work(K6_BYTES * n, 0.0)


def k7(n: int, pairs: int) -> Work:
    """K7, one plane: the value and its code in, the routed value out."""
    return Work(K7_BYTES * n, 0.0)
