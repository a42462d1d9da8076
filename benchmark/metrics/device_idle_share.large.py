"""The card's idle share of the traced window in the large-N step cells."""

from benchlib import readers

UNIT = "%"


def read(ctx):
    return readers.idle_share(ctx, "particle_steps_per_s.large")
