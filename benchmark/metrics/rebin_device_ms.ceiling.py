"""Device milliseconds a rebin of the operations launched inside the
program's rebin span, in the memory-ceiling cell (K6, five K7 and their
glue)."""

from benchlib import ceiling_readers

UNIT = "ms"


def read(ctx):
    return ceiling_readers.rebin_device_ms(ctx)
