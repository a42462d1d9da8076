"""K4 (csrc/field.cu), % of its roofline on a frame's particles."""

from benchlib import readers

UNIT = "%"


def read(ctx):
    return readers.k4_share(ctx, "frames_per_s")
