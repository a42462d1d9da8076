"""The Session's rebins per 1,000 steps in the large-N step cells."""

from benchlib import readers

UNIT = "rebins"


def read(ctx):
    return readers.rebins_per_kstep(ctx, "particle_steps_per_s.large")
