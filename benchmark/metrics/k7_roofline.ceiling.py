"""K7, one plane of the planar rebin (csrc/apply_code.cu), % of its roofline in
the memory-ceiling cell."""

from benchlib import ceiling_readers

UNIT = "%"


def read(ctx):
    return ceiling_readers.kernel_share(ctx, "k7")
