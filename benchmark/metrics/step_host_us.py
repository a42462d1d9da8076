"""Host microseconds a step spends in the program's step span, less the
runtime's synchronisation calls inside it: the enqueue and Python that the
card idles behind at 1M."""

from benchlib import spans

UNIT = "us"


def read(ctx):
    s = spans.host_seconds(ctx, "particle_steps_per_s", "bgf.step", "steps",
                           less_syncs=True)
    return None if s is None else 1e6 * s
