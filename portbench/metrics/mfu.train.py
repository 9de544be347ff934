"""The whole epoch's share of the chip's peak: the operations the
window's unprofiled training runs needed (flops.py) per second, over the
configuration's peak (roofline.py)."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
