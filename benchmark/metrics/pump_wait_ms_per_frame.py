"""Host ms a frame spends in the frame pump's wait: the event behind the
previous frame's copy to pinned memory, and its host view."""

from benchlib import spans

UNIT = "ms"


def read(ctx):
    s = spans.host_seconds(ctx, "frames_per_s", "bgf.pump.wait", "frames")
    return None if s is None else 1e3 * s
