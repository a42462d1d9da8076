"""K6, the planar rebin's routing pass (csrc/select.cu), % of its roofline in
the memory-ceiling cell."""

from benchlib import ceiling_readers

UNIT = "%"


def read(ctx):
    return ceiling_readers.kernel_share(ctx, "k6")
