"""Device microseconds a step of the operations launched inside the slab
step's halos (the edge columns' stacks, the ghost columns' copies),
matched to their launches by the runtime's correlation ids."""

from benchlib import slab_readers

UNIT = "us"


def read(ctx):
    return slab_readers.halo_device_us(ctx)
