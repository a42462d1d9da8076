"""The runtime's synchronisation calls inside the program's spans per
1,000 steps: the deliberate reads (trigger, rebin counters, re-admits,
the eager overflow) and the syncs implicit in torch operations."""

from benchlib import spans

UNIT = "syncs"


def read(ctx):
    return spans.syncs_per_kstep(ctx, "particle_steps_per_s")
