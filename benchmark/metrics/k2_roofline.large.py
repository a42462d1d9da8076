"""K2 (csrc/forces_integrate.cu), % of its roofline in the large-N step
cells."""

from benchlib import readers

UNIT = "%"


def read(ctx):
    return readers.kernel_share(ctx, "particle_steps_per_s.large", "k2")
