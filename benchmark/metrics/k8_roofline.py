"""K8 (csrc/forces.cu), % of its roofline in the 1M step cells."""

from benchlib import readers

UNIT = "%"


def read(ctx):
    return readers.kernel_share(ctx, "particle_steps_per_s", "k8")
