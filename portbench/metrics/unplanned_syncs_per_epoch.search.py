"""Host synchronizations outside every `read` span (the line searches'
planned host reads) per batched epoch of a profiled block of rho
searches (spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_epoch(ctx, 'unplanned_syncs')
