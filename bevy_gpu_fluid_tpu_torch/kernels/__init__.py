"""Build and loader for the hand-written CUDA kernels (``csrc/``)."""
