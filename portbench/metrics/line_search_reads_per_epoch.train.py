"""The line searches' host reads (`read` spans) per epoch of a profiled
block of training runs (spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_epoch(ctx, 'reads')
