"""Host microseconds a rebin spends in the program's rebin span, its
counter read included."""

from benchlib import spans

UNIT = "us"


def read(ctx):
    s = spans.host_seconds(ctx, "particle_steps_per_s", "bgf.rebin",
                           "rebins")
    return None if s is None else 1e6 * s
