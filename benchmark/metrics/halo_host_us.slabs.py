"""Host microseconds a step spends in the slab step's halos (the program's
``bgf.halo`` spans: the four planes' ghost columns, then rho's), less the
runtime's synchronisation calls inside them."""

from benchlib import slab_readers

UNIT = "us"


def read(ctx):
    return slab_readers.halo_host_us(ctx)
