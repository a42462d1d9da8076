"""Runnable examples of the port:
``python -m bevy_gpu_fluid_tpu_torch.examples.<name>``."""
