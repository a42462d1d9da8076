"""K2's refless instance (csrc/forces_integrate.cu, kRefless = true), % of its
roofline in the memory-ceiling cell."""

from benchlib import ceiling_readers

UNIT = "%"


def read(ctx):
    return ceiling_readers.kernel_share(ctx, "k2r")
