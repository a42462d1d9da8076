"""External impulse injection, the "touch the fluid" interaction (port of
``bevy_gpu_fluid_tpu/interact/impulse.py``): every particle within
``interaction_area`` (squared distance) of the cursor's world position gets
``vel += impulse * dir``, where dir is the cursor's world-space motion since
the last frame.  Elementwise, so it applies to per-particle [N] fields and
to the dense [rows, cap, lanes] slot planes alike (empty slots hold FAR
positions and are never in range).

The scalars combine as given: Python floats multiply ``impulse * dir`` in
double before the float32 add, numpy float32 scalars in float32.
"""

from __future__ import annotations

import torch

from ..core.state import FluidState

IMPULSE = 10.0            # reference demo's drag impulse
INTERACTION_AREA = 0.04   # squared radius


def apply_impulse(state: FluidState, cursor_x, cursor_y, dir_x, dir_y,
                  impulse: float = IMPULSE,
                  interaction_area: float = INTERACTION_AREA) -> FluidState:
    """vel += impulse * (dir_x, dir_y) for particles with
    |pos - cursor|^2 < interaction_area."""
    vx, vy = apply_impulse_arrays(state.x, state.y, state.vx, state.vy,
                                  cursor_x, cursor_y, dir_x, dir_y, impulse,
                                  interaction_area)
    return state.replace(vx=vx, vy=vy)


def apply_impulse_arrays(x, y, vx, vy, cursor_x, cursor_y, dir_x, dir_y,
                         impulse: float = IMPULSE,
                         interaction_area: float = INTERACTION_AREA):
    """Array form of ``apply_impulse``, shape-agnostic.  Returns (vx, vy)."""
    dx = x - float(cursor_x)
    dy = y - float(cursor_y)
    hit = dx * dx + dy * dy < float(interaction_area)
    return (torch.where(hit, vx + float(impulse * dir_x), vx),
            torch.where(hit, vy + float(impulse * dir_y), vy))
