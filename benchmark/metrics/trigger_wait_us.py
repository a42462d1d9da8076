"""Host microseconds a step blocks in the trigger read (the step's
``disp2`` brought to the host) before it may enqueue the next step."""

from benchlib import spans

UNIT = "us"


def read(ctx):
    s = spans.host_seconds(ctx, "particle_steps_per_s", "bgf.read.trigger",
                           "steps")
    return None if s is None else 1e6 * s
