"""Device ms a frame of the raster: K4, the colour planes, the quantisation."""

from benchlib import readers

UNIT = "ms"


def read(ctx):
    return readers.raster_ms(ctx, "frames_per_s")
