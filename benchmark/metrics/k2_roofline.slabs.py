"""K2 (csrc/forces_integrate.cu), % of its roofline in the slab cell: the
whole state's least time over a step's launches, one a slab."""

from benchlib import slab_readers

UNIT = "%"


def read(ctx):
    return slab_readers.kernel_share(ctx, "k2")
