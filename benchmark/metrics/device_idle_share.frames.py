"""The card's idle share of the traced window in the frame cells."""

from benchlib import readers

UNIT = "%"


def read(ctx):
    return readers.idle_share(ctx, "frames_per_s")
