"""bevy_gpu_fluid_tpu_torch — the PyTorch/CUDA port of bevy_gpu_fluid_tpu.

The 2D SPH fluid framework of ``bevy_gpu_fluid_tpu`` (JAX/XLA/Pallas on a
TPU), ported to PyTorch with hand-written CUDA kernels for the NVIDIA H100
(``csrc/``).  The JAX package stays beside it as the reference: the layout,
conventions and numerics follow it so the two compare element by element.

This package imports torch and numpy only.
"""

from .core.params import FluidParams, IntegrateConfig, GridSpec2D, GRAVITY_Y
from .core.state import (FluidState, from_positions, init_grid, demo_block_5k,
                         make_state)
from .core.simulation import Simulation

__all__ = [
    "FluidParams", "IntegrateConfig", "GridSpec2D", "GRAVITY_Y",
    "FluidState", "from_positions", "init_grid", "demo_block_5k",
    "make_state", "Simulation",
]
