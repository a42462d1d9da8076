"""Host microseconds a rebin spends in the slab rebin's exchange (the
program's ``bgf.rebin.exchange`` span: the captures in the ghost columns,
their shifts to the neighbours and the edge merges)."""

from benchlib import slab_readers

UNIT = "us"


def read(ctx):
    return slab_readers.exchange_host_us(ctx)
