"""The share of the time in which no operation ran on the device: 1 -
the device's busy time (the union of device intervals) per epoch of the
profiled stacked rho searches, over the wall time per epoch of the
window's unprofiled ones (readers.idle_share)."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
