"""Host ms a frame spends in the program's raster span: K4's launch, the
colour planes and the quantisation enqueued."""

from benchlib import spans

UNIT = "ms"


def read(ctx):
    s = spans.host_seconds(ctx, "frames_per_s", "bgf.raster", "frames")
    return None if s is None else 1e3 * s
